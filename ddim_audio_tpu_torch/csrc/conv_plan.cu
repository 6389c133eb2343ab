// The tile-plan queries of ddim_conv3x3, ddim_conv_up, ddim_conv_down,
// ddim_conv_up_int8, ddim_conv_down_int8, ddim_conv_dw (modes 0, 1, 2),
// ddim_conv3x3_int8, ddim_conv3x3_store, ddim_conv_head, ddim_conv_tail and
// ddim_residual_affine, and the
// storage group of int8 activations (conv_plan.h).
// Plain C++: nvcc builds it into the kernel library, and a host compiler
// builds it alone for the CPU tests of the port's Python model of the plans.
#include "conv_plan.h"

namespace {

int write_plan(const ddim::TilePlan& p, int* out) {
  const int v[8] = {p.variant, p.tile_t, p.tile_f, p.tiles,
                    p.groups,  p.split,  p.smem,   p.grid};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

extern "C" {

// Spatial tiles per sample of the variant that ddim_conv3x3 picks for these
// arguments (the partials' second dimension; no batch dependence).
int ddim_conv3x3_tiles(int t_len, int f_len, int c, int bf16) {
  return ddim::conv3x3_plan(t_len, f_len, c, bf16, 1).tiles;
}

// The variant ddim_conv3x3 runs: 0 CUDA cores, 1 tensor cores (bf16), 2
// split TF32 on the tensor cores (fp32).
int ddim_conv3x3_variant(int t_len, int f_len, int c, int bf16) {
  return ddim::conv3x3_plan(t_len, f_len, c, bf16, 1).variant;
}

// out[0 … 8): variant, tile_t, tile_f, tiles, groups, split, smem bytes,
// grid (persistent kernels' blocks along grid.x, else 0).
int ddim_conv3x3_plan(int t_len, int f_len, int c, int bf16, int batch,
                      int* out) {
  return write_plan(ddim::conv3x3_plan(t_len, f_len, c, bf16, batch), out);
}

// The same for ddim_conv_up, in its input geometry (T, F, C_in, C_out).
int ddim_conv_up_tiles(int t_in, int f_in, int c_in, int c_out, int bf16) {
  return ddim::conv_up_plan(t_in, f_in, c_in, c_out, bf16, 1).tiles;
}

int ddim_conv_up_variant(int t_in, int f_in, int c_in, int c_out, int bf16) {
  return ddim::conv_up_plan(t_in, f_in, c_in, c_out, bf16, 1).variant;
}

int ddim_conv_up_plan(int t_in, int f_in, int c_in, int c_out, int bf16,
                      int batch, int* out) {
  return write_plan(
      ddim::conv_up_plan(t_in, f_in, c_in, c_out, bf16, batch), out);
}

// The same for ddim_conv_down, in its input geometry (T, F, C_in, C_out).
int ddim_conv_down_tiles(int t_in, int f_in, int c_in, int c_out, int bf16) {
  return ddim::conv_down_plan(t_in, f_in, c_in, c_out, bf16, 1).tiles;
}

int ddim_conv_down_variant(int t_in, int f_in, int c_in, int c_out,
                           int bf16) {
  return ddim::conv_down_plan(t_in, f_in, c_in, c_out, bf16, 1).variant;
}

int ddim_conv_down_plan(int t_in, int f_in, int c_in, int c_out, int bf16,
                        int batch, int* out) {
  return write_plan(
      ddim::conv_down_plan(t_in, f_in, c_in, c_out, bf16, batch), out);
}

// The same for ddim_conv_up_int8, in its input geometry (T, F, C_in, C_out,
// bf16, B): `tiles` is the partials' second dimension, one a group.
int ddim_conv_up_int8_plan(int t_in, int f_in, int c_in, int c_out, int bf16,
                           int batch, int* out) {
  return write_plan(
      ddim::conv_up_int8_plan(t_in, f_in, c_in, c_out, bf16, batch), out);
}

// The same for ddim_conv_down_int8, in its input geometry (T, F, C_in,
// C_out, bf16, B): `tiles` is the partials' second dimension, one a group;
// `grid` the persistent blocks along grid.x.
int ddim_conv_down_int8_plan(int t_in, int f_in, int c_in, int c_out,
                             int bf16, int batch, int* out) {
  return write_plan(
      ddim::conv_down_int8_plan(t_in, f_in, c_in, c_out, bf16, batch), out);
}

// The plans of ddim_conv_dw in mode 0 (the 3×3 conv's weight gradient), 1
// (the down conv's) and 2 (the up conv's), each in x's geometry (T, F,
// C_in, C_out, bf16, B): `tiles` the batch's position tiles, `groups` ×
// `split` the grid, `split` the partials' first dimension.
int ddim_conv3x3_dw_plan(int t_len, int f_len, int c_in, int c_out, int bf16,
                         int batch, int* out) {
  return write_plan(
      ddim::conv3x3_dw_plan(t_len, f_len, c_in, c_out, bf16, batch), out);
}

int ddim_conv_down_dw_plan(int t_in, int f_in, int c_in, int c_out, int bf16,
                           int batch, int* out) {
  return write_plan(
      ddim::conv_down_dw_plan(t_in, f_in, c_in, c_out, bf16, batch), out);
}

int ddim_conv_up_dw_plan(int t_in, int f_in, int c_in, int c_out, int bf16,
                         int batch, int* out) {
  return write_plan(
      ddim::conv_up_dw_plan(t_in, f_in, c_in, c_out, bf16, batch), out);
}

// Threads a block of the split-TF32 weight-gradient kernel in a mode.
int ddim_dw_tf32_threads(int mode) { return ddim::dw_tf32_threads(mode); }

// The same for ddim_conv3x3_int8 (T, F, C, bf16 storage, B).
int ddim_conv3x3_int8_plan(int t_len, int f_len, int c, int bf16, int batch,
                           int* out) {
  return write_plan(ddim::conv3x3_int8_plan(t_len, f_len, c, bf16, batch),
                    out);
}

// The same for ddim_conv3x3_store (T, F, C, bf16 storage, B, and how many
// of x and the residual are int8: their scales are staged).
int ddim_conv3x3_store_plan(int t_len, int f_len, int c, int bf16, int batch,
                            int scaled, int* out) {
  return write_plan(
      ddim::conv3x3_store_plan(t_len, f_len, c, bf16, batch, scaled), out);
}

// The same for ddim_conv_head (T, F, Cin, C0, bf16, B): `tiles` is the
// statistics partials' second dimension.
int ddim_conv_head_plan(int t_len, int f_len, int c_in, int c0, int bf16,
                        int batch, int* out) {
  return write_plan(
      ddim::conv_head_plan(t_len, f_len, c_in, c0, bf16, batch), out);
}

int ddim_conv_head_variant(int t_len, int f_len, int c_in, int c0, int bf16) {
  return ddim::conv_head_plan(t_len, f_len, c_in, c0, bf16, 1).variant;
}

// The same for ddim_conv_tail (T, F, C0, Cout, bf16, B).
int ddim_conv_tail_plan(int t_len, int f_len, int c0, int c_out, int bf16,
                        int batch, int* out) {
  return write_plan(
      ddim::conv_tail_plan(t_len, f_len, c0, c_out, bf16, batch), out);
}

int ddim_conv_tail_variant(int t_len, int f_len, int c0, int c_out,
                           int bf16) {
  return ddim::conv_tail_plan(t_len, f_len, c0, c_out, bf16, 1).variant;
}

// Spatial tiles per sample of ddim_residual_affine (its partials' second
// dimension).
int ddim_residual_affine_tiles(int t_len, int f_len) {
  return ddim::residual_affine_tiles(t_len, f_len);
}

// The storage group of int8 activations: i = 0 → time rows, i = 1 →
// frequency columns.
int ddim_store_geometry(int i) {
  const int g[2] = {ddim::kTtS, ddim::kFtS};
  return i >= 0 && i < 2 ? g[i] : -1;
}

}  // extern "C"
