// The C entries of Kernels C and D at the five camera models and of
// Kernels E and F at the standard model (mixed_kernels.cuh holds the
// kernels and their design). E and F at the other models are exported by
// mixed_models_e.cu and mixed_models_f.cu. The *_rigs entries take any of
// the five widths and a rig count: one launch of each pass over R rigs,
// rig-major (the fleet); the others launch one rig. Each entry launches on
// the given stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue, launching nothing, for a width or key width it is
// not built at. pct_mixed_occupancy reports what the device makes of any
// of their first passes.

#include "mixed_kernels.cuh"

extern "C" {

int pct_mixed_gram_model_rigs(int intr_w, int n_rigs, const float *packed,
                              const float *kd, const float *uv,
                              const float *mask, const float *cmask,
                              const float *imask, const float *kmask, int cw,
                              int n_blocks, int n_keys, int loss,
                              int component, float f_scale, int chunk,
                              float *gram, float *wcc, float *wic, float *hkk,
                              float *gk, float *blk_part, float *hk_part,
                              void *stream);
int pct_mixed_gram_fused_model_rigs(
    int intr_w, int n_rigs, const float *packed, const float *kd,
    const float *uv, const float *mask, const float *cmask,
    const float *imask, const float *kmask, int cw, int n_cams, int n_ims,
    int n_keys, int loss, int component, float f_scale, int chunk,
    float *hcc, float *gc, float *wcc, float *wic, float *wci, float *gii,
    float *gi, float *corner, float *hkk, float *gk, float *blk_part,
    float *cam_part, float *wcc_part, float *hk_part, void *stream);

// Kernel F at intrinsic width intr_w (9 here; 8, 12, 16 and 18 in
// mixed_models_f.cu) and key width cw over n_rigs rigs of n_blocks blocks:
// pct_mixed_gram's arrays with every rig's rows, rig-major (kd (R, 48, K),
// kmask (R, K, cw), hkk (R, K, cw, cw), ...; mixed_models_f.cu states
// them).
int pct_mixed_gram_rigs(int intr_w, int n_rigs, const float *packed,
                        const float *kd, const float *uv, const float *mask,
                        const float *cmask, const float *imask,
                        const float *kmask, int cw, int n_blocks, int n_keys,
                        int loss, int component, float f_scale, int chunk,
                        float *gram, float *wcc, float *wic, float *hkk,
                        float *gk, float *blk_part, float *hk_part,
                        void *stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (intr_w != 9)
    return pct_mixed_gram_model_rigs(intr_w, n_rigs, packed, kd, uv, mask,
                                     cmask, imask, kmask, cw, n_blocks,
                                     n_keys, loss, component, f_scale, chunk,
                                     gram, wcc, wic, hkk, gk, blk_part,
                                     hk_part, stream);
  if (cw == 9)
    return launch_mixed<9, 9>(packed, kd, uv, mask, cmask, imask, kmask,
                              n_rigs, n_blocks, n_keys, loss, component,
                              f_scale, chunk, gram, wcc, wic, hkk, gk,
                              blk_part, hk_part, st);
  if (cw == 6)
    return launch_mixed<9, 6>(packed, kd, uv, mask, cmask, imask, kmask,
                              n_rigs, n_blocks, n_keys, loss, component,
                              f_scale, chunk, gram, wcc, wic, hkk, gk,
                              blk_part, hk_part, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel E at intrinsic width intr_w (9 here; the others in
// mixed_models_e.cu) and key width cw over n_rigs rigs of n_cams cameras:
// pct_mixed_gram_fused's arrays with every rig's rows, rig-major.
int pct_mixed_gram_fused_rigs(
    int intr_w, int n_rigs, const float *packed, const float *kd,
    const float *uv, const float *mask, const float *cmask,
    const float *imask, const float *kmask, int cw, int n_cams, int n_ims,
    int n_keys, int loss, int component, float f_scale, int chunk,
    float *hcc, float *gc, float *wcc, float *wic, float *wci, float *gii,
    float *gi, float *corner, float *hkk, float *gk, float *blk_part,
    float *cam_part, float *wcc_part, float *hk_part, void *stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (intr_w != 9)
    return pct_mixed_gram_fused_model_rigs(
        intr_w, n_rigs, packed, kd, uv, mask, cmask, imask, kmask, cw,
        n_cams, n_ims, n_keys, loss, component, f_scale, chunk, hcc, gc, wcc,
        wic, wci, gii, gi, corner, hkk, gk, blk_part, cam_part, wcc_part,
        hk_part, stream);
  if (cw == 9)
    return launch_mixed_fused<9, 9>(
        packed, kd, uv, mask, cmask, imask, kmask, n_rigs, n_cams, n_ims,
        n_keys, loss, component, f_scale, chunk, hcc, gc, wcc, wic, wci, gii,
        gi, corner, hkk, gk, blk_part, cam_part, wcc_part, hk_part, st);
  if (cw == 6)
    return launch_mixed_fused<9, 6>(
        packed, kd, uv, mask, cmask, imask, kmask, n_rigs, n_cams, n_ims,
        n_keys, loss, component, f_scale, chunk, hcc, gc, wcc, wic, wci, gii,
        gi, corner, hkk, gk, blk_part, cam_part, wcc_part, hk_part, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel F, standard model (intr_w 9; the other models:
// pct_mixed_gram_model, mixed_models_f.cu). packed (B, 96), kd (48, K), uv
// (B, K, 2), mask (B, K), cmask (B, 15), imask (B, 6), kmask (K, cw), cw in
// {6, 9} -> gram (B, 22, 22), wcc (B, 15 cw, K), wic (B, 6 cw, K), hkk
// (K, cw, cw), gk (K, cw). Scratch: blk_part (ceil(K / 128), B, 253),
// hk_part (ceil(B / chunk), 9, K).
int pct_mixed_gram(const float *packed, const float *kd, const float *uv,
                   const float *mask, const float *cmask, const float *imask,
                   const float *kmask, int cw, int n_blocks, int n_keys,
                   int loss, int component, float f_scale, int chunk,
                   float *gram, float *wcc, float *wic, float *hkk, float *gk,
                   float *blk_part, float *hk_part, void *stream) {
  return pct_mixed_gram_rigs(9, 1, packed, kd, uv, mask, cmask, imask,
                             kmask, cw, n_blocks, n_keys, loss, component,
                             f_scale, chunk, gram, wcc, wic, hkk, gk,
                             blk_part, hk_part, stream);
}

// Kernel E, standard model (intr_w 9; the other models:
// pct_mixed_gram_fused_model, mixed_models_e.cu). Same inputs over B =
// n_cams * n_ims camera-major blocks -> hcc (C, 15, 15), gc (C, 15), wcc
// (C, 15 cw, K), wic (B, 6 cw, K), wci (B, 15, 6), gii (B, 6, 6), gi (B,
// 6), corner (B,), hkk (K, cw, cw), gk (K, cw). Scratch: blk_part
// (ceil(K / 128), B, 253), cam_part (C, ceil(n_ims / chunk), ceil(K / 128),
// 253), wcc_part (C, ceil(n_ims / chunk), 45, K), hk_part
// (C * ceil(n_ims / chunk), 9, K).
int pct_mixed_gram_fused(const float *packed, const float *kd,
                         const float *uv, const float *mask,
                         const float *cmask, const float *imask,
                         const float *kmask, int cw, int n_cams, int n_ims,
                         int n_keys, int loss, int component, float f_scale,
                         int chunk, float *hcc, float *gc, float *wcc,
                         float *wic, float *wci, float *gii, float *gi,
                         float *corner, float *hkk, float *gk,
                         float *blk_part, float *cam_part, float *wcc_part,
                         float *hk_part, void *stream) {
  return pct_mixed_gram_fused_rigs(
      9, 1, packed, kd, uv, mask, cmask, imask, kmask, cw, n_cams, n_ims,
      n_keys, loss, component, f_scale, chunk, hcc, gc, wcc, wic, wci, gii,
      gi, corner, hkk, gk, blk_part, cam_part, wcc_part, hk_part, stream);
}

// Kernel D at intrinsic width intr_w (8, 9, 12, 16, 18; a = intr_w + 6,
// W = a + 7): Kernel F at cw = 3. packed (B, PPB) of that width's layout,
// keyp (K, 3), uv (B, K, 2), mask (B, K), cmask (B, a), imask (B, 6),
// kmask (K, 3) -> gram (B, W, W), wck (B, 3a, K), wik (B, 18, K),
// hkk (K, 3, 3), gk (K, 3). Scratch: blk_part (ceil(K / 128), B,
// W (W + 1) / 2), hk_part (ceil(B / chunk), 9, K). n_rigs rigs of n_blocks
// blocks each: every array with every rig's rows, rig-major (packed
// (R B, PPB), keyp (R, K, 3), kmask (R, K, 3), hkk (R, K, 3, 3), blk_part
// (ceil(K / 128), R B, ...), hk_part (R ceil(B / chunk), 9, K), ...).
// Another width returns cudaErrorInvalidValue and launches nothing.
int pct_selfcal_gram_rigs(int intr_w, int n_rigs, const float *packed,
                          const float *keyp, const float *uv,
                          const float *mask, const float *cmask,
                          const float *imask, const float *kmask,
                          int n_blocks, int n_keys, int loss, int component,
                          float f_scale, int chunk, float *gram, float *wck,
                          float *wik, float *hkk, float *gk, float *blk_part,
                          float *hk_part, void *stream) {
  switch (intr_w) {
#define PCT_CASE(IW)                                                        \
  case IW:                                                                  \
    return launch_mixed<IW, 3>(packed, keyp, uv, mask, cmask, imask, kmask, \
                               n_rigs, n_blocks, n_keys, loss, component,   \
                               f_scale, chunk, gram, wck, wik, hkk, gk,     \
                               blk_part, hk_part, (cudaStream_t)stream);
    PCT_CASE(8) PCT_CASE(9) PCT_CASE(12) PCT_CASE(16) PCT_CASE(18)
#undef PCT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel D at intrinsic width intr_w, one rig (pct_selfcal_gram_rigs at
// n_rigs = 1).
int pct_selfcal_gram_model(int intr_w, const float *packed,
                           const float *keyp, const float *uv,
                           const float *mask, const float *cmask,
                           const float *imask, const float *kmask,
                           int n_blocks, int n_keys, int loss, int component,
                           float f_scale, int chunk, float *gram, float *wck,
                           float *wik, float *hkk, float *gk,
                           float *blk_part, float *hk_part, void *stream) {
  return pct_selfcal_gram_rigs(intr_w, 1, packed, keyp, uv, mask, cmask,
                               imask, kmask, n_blocks, n_keys, loss,
                               component, f_scale, chunk, gram, wck, wik, hkk,
                               gk, blk_part, hk_part, stream);
}

// Kernel D, standard model: pct_selfcal_gram_model at intr_w 9 (packed
// (B, 96), gram (B, 22, 22), wck (B, 45, K), blk_part (..., 253)).
int pct_selfcal_gram(const float *packed, const float *keyp, const float *uv,
                     const float *mask, const float *cmask,
                     const float *imask, const float *kmask, int n_blocks,
                     int n_keys, int loss, int component, float f_scale,
                     int chunk, float *gram, float *wck, float *wik,
                     float *hkk, float *gk, float *blk_part, float *hk_part,
                     void *stream) {
  return launch_mixed<9, 3>(packed, keyp, uv, mask, cmask, imask, kmask, 1,
                            n_blocks, n_keys, loss, component, f_scale,
                            chunk, gram, wck, wik, hkk, gk, blk_part,
                            hk_part, (cudaStream_t)stream);
}

// Kernel C at intrinsic width intr_w: Kernel E at cw = 3, with no cmask.
// Same inputs over B = n_cams * n_ims camera-major blocks -> hcc (C, a, a),
// gc (C, a), wck (C, 3a, K), wik (B, 18, K), wci (B, a, 6), gii (B, 6, 6),
// gi (B, 6), corner (B,), hkk (K, 3, 3), gk (K, 3). Scratch: blk_part
// (ceil(K / 128), B, W (W + 1) / 2), cam_part (C, ceil(n_ims / chunk),
// ceil(K / 128), W (W + 1) / 2), wck_part (C, ceil(n_ims / chunk), 3a, K),
// hk_part (C * ceil(n_ims / chunk), 9, K). n_rigs rigs of n_cams cameras:
// every array with every rig's rows, rig-major, as pct_selfcal_gram_rigs.
// Another width returns cudaErrorInvalidValue and launches nothing.
int pct_selfcal_gram_fused_rigs(
    int intr_w, int n_rigs, const float *packed, const float *keyp,
    const float *uv, const float *mask, const float *imask,
    const float *kmask, int n_cams, int n_ims, int n_keys, int loss,
    int component, float f_scale, int chunk, float *hcc, float *gc,
    float *wck, float *wik, float *wci, float *gii, float *gi, float *corner,
    float *hkk, float *gk, float *blk_part, float *cam_part, float *wck_part,
    float *hk_part, void *stream) {
  switch (intr_w) {
#define PCT_CASE(IW)                                                        \
  case IW:                                                                  \
    return launch_mixed_fused<IW, 3>(                                       \
        packed, keyp, uv, mask, nullptr, imask, kmask, n_rigs, n_cams,      \
        n_ims, n_keys, loss, component, f_scale, chunk, hcc, gc, wck, wik,  \
        wci, gii, gi, corner, hkk, gk, blk_part, cam_part, wck_part,        \
        hk_part, (cudaStream_t)stream);
    PCT_CASE(8) PCT_CASE(9) PCT_CASE(12) PCT_CASE(16) PCT_CASE(18)
#undef PCT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel C at intrinsic width intr_w, one rig (pct_selfcal_gram_fused_rigs
// at n_rigs = 1).
int pct_selfcal_gram_fused_model(
    int intr_w, const float *packed, const float *keyp, const float *uv,
    const float *mask, const float *imask, const float *kmask, int n_cams,
    int n_ims, int n_keys, int loss, int component, float f_scale, int chunk,
    float *hcc, float *gc, float *wck, float *wik, float *wci, float *gii,
    float *gi, float *corner, float *hkk, float *gk, float *blk_part,
    float *cam_part, float *wck_part, float *hk_part, void *stream) {
  return pct_selfcal_gram_fused_rigs(
      intr_w, 1, packed, keyp, uv, mask, imask, kmask, n_cams, n_ims, n_keys,
      loss, component, f_scale, chunk, hcc, gc, wck, wik, wci, gii, gi,
      corner, hkk, gk, blk_part, cam_part, wck_part, hk_part, stream);
}

// Kernel C, standard model: pct_selfcal_gram_fused_model at intr_w 9
// (hcc (C, 15, 15), wck (C, 45, K), scratch entries 253).
int pct_selfcal_gram_fused(const float *packed, const float *keyp,
                           const float *uv, const float *mask,
                           const float *imask, const float *kmask, int n_cams,
                           int n_ims, int n_keys, int loss, int component,
                           float f_scale, int chunk, float *hcc, float *gc,
                           float *wck, float *wik, float *wci, float *gii,
                           float *gi, float *corner, float *hkk, float *gk,
                           float *blk_part, float *cam_part, float *wck_part,
                           float *hk_part, void *stream) {
  return launch_mixed_fused<9, 3>(packed, keyp, uv, mask, nullptr, imask,
                                  kmask, 1, n_cams, n_ims, n_keys, loss,
                                  component, f_scale, chunk, hcc, gc, wck,
                                  wik, wci, gii, gi, corner, hkk, gk,
                                  blk_part, cam_part, wck_part, hk_part,
                                  (cudaStream_t)stream);
}

int pct_mixed_gram_fused_model_occupancy(int intr_w, int cw, int *out);
int pct_mixed_gram_model_occupancy(int intr_w, int cw, int *out);

// The first pass of Kernel C/E (fused 1) or D/F (fused 0) at intrinsic
// width intr_w and key width cw (3: C/D; 9, 6: E/F) as the device holds it
// (mixed_kernels.cuh first_pass_occupancy) -> out[6]: blocks an SM, dynamic
// and static shared memory bytes, registers, local bytes a thread, the
// blocks an SM its launch bounds ask for. E and F at the other models are
// answered by their own units (pct_mixed_gram{,_fused}_model_occupancy);
// another width or key width returns cudaErrorInvalidValue.
int pct_mixed_occupancy(int intr_w, int cw, int fused, int *out) {
  if (intr_w == 9) {
    if (cw == 3)
      return fused ? first_pass_occupancy<9, 3, true>(out)
                   : first_pass_occupancy<9, 3, false>(out);
    if (cw == 9)
      return fused ? first_pass_occupancy<9, 9, true>(out)
                   : first_pass_occupancy<9, 9, false>(out);
    if (cw == 6)
      return fused ? first_pass_occupancy<9, 6, true>(out)
                   : first_pass_occupancy<9, 6, false>(out);
    return (int)cudaErrorInvalidValue;
  }
  if (cw != 3)
    return fused ? pct_mixed_gram_fused_model_occupancy(intr_w, cw, out)
                 : pct_mixed_gram_model_occupancy(intr_w, cw, out);
  switch (intr_w) {
#define PCT_CASE(IW)                                      \
  case IW:                                                \
    return fused ? first_pass_occupancy<IW, 3, true>(out) \
                 : first_pass_occupancy<IW, 3, false>(out);
    PCT_CASE(8) PCT_CASE(12) PCT_CASE(16) PCT_CASE(18)
#undef PCT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
