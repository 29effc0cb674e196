// Batched Newton solve of MuJoCo's soft-constraint problem, for Hopper.
//
// Replaces the Pallas TPU kernel quadruped_tpu/ops/newton.py
// (_newton_solve_jit -> pl.pallas_call, body newton_core) in both of its
// Gram modes, "vpu" and "mxu".  Same function, per env: warm-started
// primal Newton on
//   Phi(a) = 1/2 |a - a_smooth|_M^2 + sum_i s_i(J a - aref)
// with Huber dof-friction rows, one-sided limit rows and elliptic cones
// per condim pool; H = M + J^T diag(w) J + 3 rank-1 cone rows per friction
// contact + 1e-10 I; an nv x nv Cholesky with a 1e-3*maxdiag Levenberg
// retry and a zero step if both factorizations fail; a ladder line search
// (NaN-safe first-minimum argmin) with one parabolic refinement.  Outputs
// qacc, the row forces f and qfrc = J^T f.
//
// What bounds it.  FP32 operations, not bytes (H100 SXM peaks: 67
// TFLOP/s, 3.35 TB/s).  Only the active contact slots do work (2-5 of 48
// on the configuration of record's states), and chip_smoke.py counts
// operations and bytes on those: at 4096 envs and 8 iterations on its
// after-step states (2.17 active slots per env), 1.157 GFLOP = 0.0173 ms
// against 22.6 MB = 0.0067 ms.  Counting every slot, as a kernel that
// skipped none would work, 6.049 GFLOP = 0.0903 ms.
//
// What held the previous design back (one 128-thread block per env,
// everything in shared memory; its clock-stamp phase split on an NVIDIA
// H100 80GB HBM3 at 700 W, 4096 envs, 8 iterations: ladder 28%, Cholesky
// and solves 24%, z and f/w with the stored rank-1 rows 20%, Gram 12-15%,
// argmin and vertex 7%, grad 3%): 123 registers x 128 threads left 4
// envs resident per SM; about 12 __syncthreads per iteration while one
// warp ran the serial phases; a Cholesky through shared memory with 4
// __syncwarp per pivot; 18 penalty evaluations with a division per
// contact row and lanes on contacts of different condim; the rank-1 rows
// written to shared memory by 36 threads; and every inactive contact slot
// carried through the Gram and the line search.
//
// Design (each point against one of those):
//  * One warp per env, up to 4 envs per block (make_params lays out an
//    env's shared arrays and takes the block size at which the occupancy
//    API keeps the most envs resident; the ragged last block's spare
//    warps return at once).  No __syncthreads: only __syncwarp.  Every
//    reduction is a warp shuffle or a sequential sum in a fixed order, so
//    an env's result does not depend on the launch.
//  * Shared memory per env: J (ne x nv, stride nv: lanes over rows read
//    float2s, which for nv 18 hit all 32 banks once per half-warp), aref,
//    z, f, Jd, per-row tables and per-contact scalars, 18,960 B on the
//    pooled layout, so 12 envs per SM; M, a, qs, delta, grad and the
//    Cholesky factor live in registers (lane i: row i).
//  * No stored U: the rank-1 rows of a friction contact are formed in
//    registers from the contact's J rows inside the Gram.
//  * Inactive contact slots (con_active 0) are skipped in grad, Gram and
//    line search: their f, w and rank-1 weights are exactly 0, so those
//    sums are unchanged; in the line search each would add the same
//    alpha-independent ~1e-30 Rn to S, below float32 resolution.
//  * Cholesky and triangular solves in registers: lane i holds row i of
//    H; columns broadcast by __shfl_sync; nv is a template parameter
//    (instantiated for 18, the Go1 and Go2 width; other widths raise).
//    The Levenberg retry refactors from the Gram kept in shared memory.
//  * Line search with the 17 candidates (16 rungs and 0) on the lanes:
//    every lane walks the same rows and contacts, so shared reads are
//    broadcasts and condim causes no divergence; sc*mk/Rn and
//    1/(1+mu^2) are tabled per solve, so no candidate divides.  The
//    argmin is a shuffle reduction on (phi, index), first minimum on
//    ties; the vertex is evaluated with lanes over rows and contacts.
//  * vpu Gram: lane b < 21 owns a 3 x 3 block of the 6 x 6 block upper
//    triangle (nv 18): per weighted row 6 loads, 3 multiplies and 9 FMAs,
//    the J rows summed first and the rank-1 rows apart, as before.
//  * mxu Gram: the warp computes the 6 upper 8 x 8 tiles of the padded
//    24 x 24 Gram with FP64 mma.sync.m8n8k4, six independent accumulators
//    per k-step; friction and limit rows in k-steps of 4, each active
//    contact's rows in k-steps of its own, and its three rank-1 rows as
//    one more k-step built in registers.
//
// Precision (mxu).  Operands widened from float32 to double, w X formed
// in double (exact: the product of two floats), accumulation in double
// on the FP64 tensor cores (DMMA), the sum rounded to float32 once before
// M is added.  Every product and sum after the widening carries ~1e-16
// relative error, so the float32 Gram is within one rounding of the exact
// J^T diag(w) J + U^T diag(wU) U: no less accurate than the vpu path's
// float32 sum, and H stays positive definite wherever the vpu path's
// does (the exact Gram is positive semidefinite, M is positive definite,
// and the perturbation is a float32 rounding of each entry).  A single
// TF32 pass (10-bit mantissa) would perturb H by ~1e-3 relative and break
// that; 3xTF32 would need three MMAs and a split of every operand, where
// DMMA needs one MMA and no split.  On the H100 SXM, FP64 tensor cores
// and FP32 CUDA cores have the same dense peak, 67 TFLOP/s.
//
// Built without --use_fast_math: the solve depends on IEEE semantics (a
// negative pivot gives NaN, which triggers the Levenberg retry; NaN line
// search candidates lose the argmin; non-finite steps are zeroed).
//
// Masks (con_dim_mask, con_active) are 0/1 floats, as the wrapper
// documents; the tables fold them in exactly under that rule.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_POOLS 4
#define MAX_LADDER 32
#define MAX_EPB 4
#define FULL 0xffffffffu
#define NPHASE 9  // phases of the profile (ops/newton.py:PHASES)

// kernel kinds: the solve, the solve with phase stamps, the Gram alone
#define KIND_SOLVE 0
#define KIND_PROFILE 1
#define KIND_GRAM 2

// One env's arrays in shared memory, in this order (env_layout computes
// their offsets in floats).  J (ne, nv); aref, z, jd, f (ne), jd and f
// adjoining: between the Gram and Jd they hold the Gram and then the
// Cholesky factor (nv x nv); wfl, fD (nf + nl): weights and D of the
// dof-friction and limit rows; fl, fR (nf); lact (nl); cc, cfm, cSm, csc
// (contact rows): sc*mk/Rn, fsc*mk, sc*mk, sc; Rn, mu, imu = 1/(1+mu^2),
// cac, wk, wV0, wVn (contacts); act (K ints): the active contacts, in
// slot order, built once per solve.
enum {
  O_J, O_AREF, O_Z, O_JD, O_F, O_WFL, O_FD, O_FL, O_FR, O_LACT, O_CC, O_CFM,
  O_CSM, O_CSC, O_RN, O_MU, O_IMU, O_CAC, O_WK, O_WV0, O_WVN, O_ACT, NOFF
};

// an active contact of the list at O_ACT: slot k, condim dp, first
// contact row rc (make_params checks K < 256 and the rows < 2^19)
__device__ __forceinline__ void unpack_act(int v, int& k, int& dp, int& rc) {
  k = v & 255;
  dp = (v >> 8) & 15;
  rc = v >> 12;
}

struct Params {
  int B, nf, nl, ne, K, npool, iterations, nladder, epb, env_floats;
  int pool_k[MAX_POOLS], pool_dim[MAX_POOLS];
  int pool_row[MAX_POOLS];  // first contact row of the pool
  int pool_con[MAX_POOLS];  // first contact slot of the pool
  int off[NOFF];
  float ladder[MAX_LADDER + 1];  // nladder rungs, then 0
};

struct Inputs {
  const float *M, *qs, *warm, *J, *aref, *D, *R, *floss, *active;
  const float *scale, *fscale, *maskd, *conact, *Rn, *mu;
  float *qacc, *f, *qfrc;
  long long* prof;  // KIND_PROFILE: (B, NPHASE + 1) cycles
  float* H;         // KIND_GRAM: (B, nv, nv)
};

__device__ __forceinline__ float clampf_nan(float x, float lo, float hi) {
  // jnp.clip semantics: NaN stays NaN
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// out[r] = sum_i J[r, i] * x_i (- sub[r]), lanes over rows; x broadcast
// in registers; float2 reads of J rows at stride NV (even)
template <int NV>
__device__ __forceinline__ void rows_dot(const float* J, const float* xb,
                                         const float* sub, float* out, int ne,
                                         int lane) {
#pragma unroll 2
  for (int r = lane; r < ne; r += 32) {
    const float2* Jr = reinterpret_cast<const float2*>(J + r * NV);
    float2 v = Jr[0];
    float acc = v.x * xb[0];
    acc = acc + v.y * xb[1];
#pragma unroll
    for (int m = 1; m < NV / 2; ++m) {
      v = Jr[m];
      acc = acc + v.x * xb[2 * m];
      acc = acc + v.y * xb[2 * m + 1];
    }
    out[r] = sub ? acc - sub[r] : acc;
  }
}

// penalty of dof-friction row r (< nf) at z
__device__ __forceinline__ float fric_S(const Params& p, const float* sm, int r,
                                        float z) {
  const float Dr = sm[p.off[O_FD] + r], fl = sm[p.off[O_FL] + r];
  const bool quad = fabsf(Dr * z) <= fl;
  return quad ? 0.5f * Dr * z * z
              : fl * fabsf(z) - 0.5f * fl * fl * sm[p.off[O_FR] + r];
}

// penalty of limit row r (nf <= r < nf + nl) at z
__device__ __forceinline__ float lim_S(const Params& p, const float* sm, int r,
                                       float z) {
  const float Dr = sm[p.off[O_FD] + r];
  const bool act = (sm[p.off[O_LACT] + r - p.nf] > 0.f) && (z < 0.f);
  return act ? 0.5f * Dr * z * z : 0.f;
}

// cone penalty of contact k (first contact row rc, row r = nf + nl + rc,
// dim dp) at z + alpha * jd, from the tables: no division
__device__ __forceinline__ float con_S(const Params& p, const float* sm, int k,
                                       int rc, int r, int dp, float alpha) {
  const float* z = sm + p.off[O_Z] + r;
  const float* jd = sm + p.off[O_JD] + r;
  const float* cc = sm + p.off[O_CC] + rc;
  float Rn = sm[p.off[O_RN] + k], mu = sm[p.off[O_MU] + k];
  float imu = sm[p.off[O_IMU] + k];
  float u0 = -((z[0] + alpha * jd[0]) * cc[0]);
  float tt = 0.f;
#pragma unroll
  for (int d = 1; d < 6; ++d) {
    if (d < dp) {
      float u = -((z[d] + alpha * jd[d]) * cc[d]);
      tt += u * u;
    }
  }
  float t = sqrtf(tt + 1e-30f);
  bool bottom = t <= mu * u0;
  bool top = mu * t <= -u0;
  float usq = u0 * u0 + tt;
  float al = (u0 + mu * t) * imu;
  float mid_d2 = usq - al * al * (1.f + mu * mu);
  float d2 = bottom ? 0.f : (top ? usq : mid_d2);
  return 0.5f * Rn * (usq - d2);
}

// Forces and weights at z, with the reference's arithmetic (penalty_fw):
// f and w of the dof-friction and limit rows; f of the active contacts'
// rows, and per active contact wk (its rows' weights are (wk * cSm) *
// csc) and, with want_u, the rank-1 row weights wV0, wVn and
// coefficients cn_d (in jd, at the contact's rows d >= 1).  An inactive
// slot's f is 0 and is written only with the outputs.  Lanes over rows,
// then over the active contacts (condim 1-6 by predication).
__device__ __forceinline__ void penalty_fw(const Params& p, float* sm,
                                           bool want_u, int nact, int lane) {
  const float* z = sm + p.off[O_Z];
  float* f = sm + p.off[O_F];
  const int nfl = p.nf + p.nl;
  for (int r = lane; r < nfl; r += 32) {
    float Dr = sm[p.off[O_FD] + r], zr = z[r];
    float fr, wr;
    if (r < p.nf) {
      float fl = sm[p.off[O_FL] + r];
      float f_unc = -Dr * zr;
      bool quad = fabsf(f_unc) <= fl;
      fr = clampf_nan(f_unc, -fl, fl);
      wr = quad ? Dr : 0.f;
    } else {
      bool act = (sm[p.off[O_LACT] + r - p.nf] > 0.f) && (zr < 0.f);
      fr = act ? -Dr * zr : 0.f;
      wr = act ? Dr : 0.f;
    }
    f[r] = fr;
    sm[p.off[O_WFL] + r] = wr;
  }
  const int* act = reinterpret_cast<const int*>(sm + p.off[O_ACT]);
  for (int i = lane; i < nact; i += 32) {
    int k, dp, rc;
    unpack_act(act[i], k, dp, rc);
    const int r = nfl + rc;
    const float* cSm = sm + p.off[O_CSM] + rc;
    const float* cfm = sm + p.off[O_CFM] + rc;
    float Rn = sm[p.off[O_RN] + k], mu = sm[p.off[O_MU] + k];
    float cac = sm[p.off[O_CAC] + k];
    float u[6];
    float tt = 0.f;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      u[d] = 0.f;
      if (d < dp) {
        u[d] = -(z[r + d] * cSm[d]) / Rn;
        if (d > 0) tt += u[d] * u[d];
      }
    }
    float u0 = u[0];
    float t = sqrtf(tt + 1e-30f);
    bool bottom = t <= mu * u0;
    bool top = mu * t <= -u0;
    bool middle = !(bottom || top);
    float al = (u0 + mu * t) / (1.f + mu * mu);
    float phi0 = bottom ? u0 : (top ? 0.f : al);
    float mid_c = mu * al / t;
    float diag_c = bottom ? 1.f : (top ? 0.f : mid_c);
    f[r] = phi0 * cfm[0];
#pragma unroll
    for (int d = 1; d < 6; ++d) {
      if (d < dp) {
        float tdir = u[d] / t;
        float phi = bottom ? u[d] : (top ? 0.f : mu * al * tdir);
        f[r + d] = phi * cfm[d];
      }
    }
    sm[p.off[O_WK] + k] = diag_c * cac / Rn;
    if (want_u && dp > 1) {
      float* cn = sm + p.off[O_JD] + r;
#pragma unroll
      for (int d = 1; d < 6; ++d)
        if (d < dp) cn[d] = cSm[d] * (u[d] / t);
      float is_mid = (middle ? 1.f : 0.f) * cac;
      float wVn = -is_mid * mid_c / Rn;
      sm[p.off[O_WV0] + k] = is_mid / ((1.f + mu * mu) * Rn);
      sm[p.off[O_WVN] + k] = wVn;
    }
  }
}

// lane i < NV: sum_r J[r, i] f[r] in row order over the dof-friction and
// limit rows and the active contacts' rows (an inactive slot's f is 0)
template <int NV>
__device__ __forceinline__ float jtf(const Params& p, const float* sm, int nact,
                                     int lane) {
  const float* J = sm + p.off[O_J];
  const float* f = sm + p.off[O_F];
  const int* act = reinterpret_cast<const int*>(sm + p.off[O_ACT]);
  const int col = lane < NV ? lane : 0;
  const int nfl = p.nf + p.nl;
  float acc = 0.f;
#pragma unroll 4
  for (int r = 0; r < nfl; ++r) acc += J[r * NV + col] * f[r];
  for (int i = 0; i < nact; ++i) {
    int k, dp, rc;
    unpack_act(act[i], k, dp, rc);
    const int r = nfl + rc;
    for (int d = 0; d < dp; ++d) acc += J[(r + d) * NV + col] * f[r + d];
  }
  return acc;
}

// ---- Gram, "vpu": CUDA cores ------------------------------------------
// Lane b < NG (NG + 1) / 2 owns the 3 x 3 block (I, J), I <= J, of the
// NG x NG block upper triangle (NG = NV / 3); the other lanes repeat
// block 0 and write nothing.  hj sums the J rows in row order, hu the
// rank-1 rows contact by contact (v, e0, n); G = hj + hu, as the
// reference sums them.
template <int NV>
__device__ __forceinline__ void gram_vpu(const Params& p, float* sm, int nact,
                                         int lane, float* G) {
  static_assert(NV % 3 == 0, "the vpu Gram tiles nv by 3");
  constexpr int NG = NV / 3;
  constexpr int NB = NG * (NG + 1) / 2;
  static_assert(NB <= 32, "one block per lane");
  int I = 0, rem = lane < NB ? lane : 0;
  while (rem >= NG - I) { rem -= NG - I; ++I; }
  const int i0 = 3 * I, j0 = 3 * (I + rem);
  const float* J = sm + p.off[O_J];
  float hj[3][3], hu[3][3];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n) { hj[m][n] = 0.f; hu[m][n] = 0.f; }

  const int nfl = p.nf + p.nl;
  const int* act = reinterpret_cast<const int*>(sm + p.off[O_ACT]);
#pragma unroll 4
  for (int r = 0; r < nfl; ++r) {
    const float wr = sm[p.off[O_WFL] + r];
    const float* Jr = J + r * NV;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float wx = Jr[i0 + m] * wr;
#pragma unroll
      for (int n = 0; n < 3; ++n) hj[m][n] += wx * Jr[j0 + n];
    }
  }
  for (int i = 0; i < nact; ++i) {
    int k, dp, rc;
    unpack_act(act[i], k, dp, rc);
    const int r = nfl + rc;
    const float* cSm = sm + p.off[O_CSM] + rc;
    const float* csc = sm + p.off[O_CSC] + rc;
    const float wk = sm[p.off[O_WK] + k];
    float x[6][3], y[6][3];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      if (d < dp) {
        const float* Jr = J + (r + d) * NV;
#pragma unroll
        for (int m = 0; m < 3; ++m) { x[d][m] = Jr[i0 + m]; y[d][m] = Jr[j0 + m]; }
        float wd = (wk * cSm[d]) * csc[d];
        if (wd != 0.f) {
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            float wx = x[d][m] * wd;
#pragma unroll
            for (int n = 0; n < 3; ++n) hj[m][n] += wx * y[d][n];
          }
        }
      }
    }
    if (dp < 2) continue;
    const float wv0 = sm[p.off[O_WV0] + k], wvn = sm[p.off[O_WVN] + k];
    if (wv0 == 0.f && wvn == 0.f) continue;
    const float* cn = sm + p.off[O_JD] + r;
    const float Sm0 = cSm[0], mu = sm[p.off[O_MU] + k];
    float ex[3], ey[3], nx[3], ny[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      ex[m] = Sm0 * x[0][m];
      ey[m] = Sm0 * y[0][m];
      nx[m] = cn[1] * x[1][m];
      ny[m] = cn[1] * y[1][m];
    }
#pragma unroll
    for (int d = 2; d < 6; ++d) {
      if (d < dp) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          nx[m] = nx[m] + cn[d] * x[d][m];
          ny[m] = ny[m] + cn[d] * y[d][m];
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float vxm = ex[m] + mu * nx[m];
      const float av = vxm * wv0, ae = ex[m] * wvn, an = nx[m] * wvn;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const float vyn = ey[n] + mu * ny[n];
        hu[m][n] += av * vyn;
        hu[m][n] += ae * ey[n];
        hu[m][n] += an * ny[n];
      }
    }
  }
  __syncwarp();  // every lane is done with the coefficients in jd
  if (lane < NB) {
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const int i = i0 + m, j = j0 + n;
        if (i <= j) {
          float g = hj[m][n] + hu[m][n];
          G[i * NV + j] = g;
          G[j * NV + i] = g;
        }
      }
  }
}

// ---- Gram, "mxu": FP64 tensor cores -------------------------------------
// Lane (g, q) = (lane >> 2, lane & 3).  Per k-step of 4 rows, lane holds
// x_t = X[row q][8 t + g] (0 past nv) and the row's weight w; A[m][k] =
// X[k][8 ti + m] and B[k][n] = w[k] X[k][8 tj + n] (PTX mma.m8n8k4 .f64
// fragments: lane l holds A[l >> 2][l & 3], B[l & 3][l >> 2] and
// C[l >> 2][2 (l & 3) + e]).
template <int NT>
struct MxuAcc {
  double c[NT * (NT + 1) / 2][2];
};

template <int NT>
__device__ __forceinline__ void mxu_kstep(MxuAcc<NT>& acc, const float* x,
                                          float w) {
  double a[NT], b[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    a[t] = (double)x[t];
    b[t] = (double)w * a[t];
  }
  int tile = 0;
#pragma unroll
  for (int ti = 0; ti < NT; ++ti)
#pragma unroll
    for (int tj = ti; tj < NT; ++tj, ++tile)
      asm volatile(
          "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
          "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
          : "+d"(acc.c[tile][0]), "+d"(acc.c[tile][1])
          : "d"(a[ti]), "d"(b[tj]));
}

template <int NV>
__device__ __forceinline__ void gram_mxu(const Params& p, float* sm, int nact,
                                         int lane, float* G) {
  constexpr int NT = (NV + 7) / 8;
  const int g = lane >> 2, q = lane & 3;
  const float* J = sm + p.off[O_J];
  MxuAcc<NT> acc;
#pragma unroll
  for (int t = 0; t < NT * (NT + 1) / 2; ++t) acc.c[t][0] = acc.c[t][1] = 0.0;
  float x[NT];

  const int nfl = p.nf + p.nl;
  for (int r0 = 0; r0 < nfl; r0 += 4) {
    const int r = r0 + q;
    const bool in = r < nfl;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      x[t] = (in && 8 * t + g < NV) ? J[r * NV + 8 * t + g] : 0.f;
    const float w = in ? sm[p.off[O_WFL] + r] : 0.f;
    if (__any_sync(FULL, w != 0.f)) mxu_kstep<NT>(acc, x, w);  // else adds 0
  }
  const int* act = reinterpret_cast<const int*>(sm + p.off[O_ACT]);
  for (int i = 0; i < nact; ++i) {
    int k, dp, rc;
    unpack_act(act[i], k, dp, rc);
    const int r = nfl + rc;
    const float* cSm = sm + p.off[O_CSM] + rc;
    const float* csc = sm + p.off[O_CSC] + rc;
    const float wk = sm[p.off[O_WK] + k];
    for (int d0 = 0; d0 < dp; d0 += 4) {
      const int d = d0 + q;
      const bool in = d < dp;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        x[t] = (in && 8 * t + g < NV) ? J[(r + d) * NV + 8 * t + g] : 0.f;
      mxu_kstep<NT>(acc, x, in ? (wk * cSm[d]) * csc[d] : 0.f);
    }
    if (dp < 2) continue;
    const float wv0 = sm[p.off[O_WV0] + k], wvn = sm[p.off[O_WVN] + k];
    if (wv0 == 0.f && wvn == 0.f) continue;
    // the three rank-1 rows (v, e0, n) on q = 0, 1, 2; q = 3 is zero
    const float* cn = sm + p.off[O_JD] + r;
    const float Sm0 = cSm[0], mu = sm[p.off[O_MU] + k];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = 8 * t + g;
      float e = 0.f, n = 0.f;
      if (c < NV) {
        e = Sm0 * J[r * NV + c];
        n = cn[1] * J[(r + 1) * NV + c];
        for (int dd = 2; dd < dp; ++dd) n = n + cn[dd] * J[(r + dd) * NV + c];
      }
      const float v = e + mu * n;
      x[t] = q == 0 ? v : (q == 1 ? e : (q == 2 ? n : 0.f));
    }
    mxu_kstep<NT>(acc, x, q == 0 ? wv0 : (q == 3 ? 0.f : wvn));
  }
  __syncwarp();  // every lane is done with the coefficients in jd
  int tile = 0;
#pragma unroll
  for (int ti = 0; ti < NT; ++ti)
#pragma unroll
    for (int tj = ti; tj < NT; ++tj, ++tile)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * ti + g, j = 8 * tj + 2 * q + e;
        if (i < NV && j < NV && i <= j) {
          float h = (float)acc.c[tile][e];
          G[i * NV + j] = h;
          G[j * NV + i] = h;
        }
      }
}

// In-place right-looking Cholesky of the rows h (lane li holds row li,
// columns 0..li used), with the reference's rsqrt pivot (lax.rsqrt;
// torch.rsqrt in the plain version): NaN on a negative pivot.  Returns
// the lane's own pivot rsqrt(W_ii) = 1/L_ii, which the triangular solves
// multiply by.
template <int NV>
__device__ __forceinline__ float chol_rows(float* h, int li) {
  float inv = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float pivot = rsqrtf(__shfl_sync(FULL, h[j], j));
    const float col = h[j] * pivot;
    if (li == j) inv = pivot;
    if (li >= j) h[j] = col;
#pragma unroll
    for (int k = j + 1; k < NV; ++k) {
      const float ck = __shfl_sync(FULL, col, k);
      if (li >= k) h[k] -= col * ck;
    }
  }
  return inv;
}

// per-phase cycles in 32 bits (clock() deltas wrap correctly; a phase
// sums well under 2^32 cycles per solve), the total in 64
#define STAMP(ph)                   \
  if (KIND == KIND_PROFILE) {       \
    __syncwarp();                   \
    const unsigned t_ = clock();    \
    cyc[ph] += t_ - t_prev;         \
    t_prev = t_;                    \
  }

// GRAM: 0 = "vpu", 1 = "mxu"; KIND: KIND_SOLVE, KIND_PROFILE, KIND_GRAM
template <int NV, int GRAM, int KIND>
__global__ void __launch_bounds__(32 * MAX_EPB, 3)
newton_kernel(Params p, Inputs in) {
  static_assert(NV % 2 == 0 && NV <= 32, "a lane per dof, float2 J rows");
  extern __shared__ __align__(16) float smem[];
  unsigned cyc[NPHASE];
#pragma unroll
  for (int i = 0; i < NPHASE; ++i) cyc[i] = 0;
  const long long t_start = clock64();
  unsigned t_prev = clock();

  const int lane = threadIdx.x & 31, slot = threadIdx.x >> 5;
  const int b = blockIdx.x * p.epb + slot;
  if (b >= p.B) return;  // the ragged last block's spare warps
  float* sm = smem + slot * p.env_floats;
  const int ne = p.ne, K = p.K, nfl = p.nf + p.nl;
  const int li = lane < NV ? lane : 0;  // lanes past nv repeat row 0

  // ---- stage this env's inputs ----------------------------------------
  float Mrow[NV];
  float a, qs;
  int nact = 0;
  {
    float* Js = sm + p.off[O_J];
    const int n = ne * NV;
    const float* gJ = in.J + (size_t)b * n;
    if ((n & 3) == 0 && ((uintptr_t)gJ & 15) == 0) {
      // 16-byte loads, 8 in flight per lane
      const float4* s4 = reinterpret_cast<const float4*>(gJ);
      float4* d4 = reinterpret_cast<float4*>(Js);
      const int n4 = n / 4;
      for (int i0 = lane; i0 < n4; i0 += 8 * 32) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (i0 + 32 * u < n4) v[u] = s4[i0 + 32 * u];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (i0 + 32 * u < n4) d4[i0 + 32 * u] = v[u];
      }
    } else {
      for (int i = lane; i < n; i += 32) Js[i] = gJ[i];
    }
    const size_t ro = (size_t)b * ne;
#pragma unroll 4
    for (int r = lane; r < ne; r += 32) sm[p.off[O_AREF] + r] = in.aref[ro + r];
    for (int r = lane; r < nfl; r += 32) {
      sm[p.off[O_FD] + r] = in.D[ro + r];
      if (r < p.nf) {
        sm[p.off[O_FL] + r] = in.floss[ro + r];
        sm[p.off[O_FR] + r] = in.R[ro + r];
      } else {
        sm[p.off[O_LACT] + r - p.nf] = in.active[ro + r];
      }
    }
    const size_t co = (size_t)b * K;
#pragma unroll 3
    for (int i = lane; i < K * 6; i += 32) {
      const int k = i / 6, d = i - 6 * k;
      int q = 0;
      while (q + 1 < p.npool && k >= p.pool_con[q + 1]) ++q;
      const int dp = p.pool_dim[q];
      if (d < dp) {
        const int rc = p.pool_row[q] + (k - p.pool_con[q]) * dp + d;
        const float sc = in.scale[co * 6 + i];
        const float mk = in.maskd[co * 6 + i] * in.conact[co + k];
        const float Sm = sc * mk;
        sm[p.off[O_CC] + rc] = Sm / in.Rn[co + k];
        sm[p.off[O_CFM] + rc] = in.fscale[co * 6 + i] * mk;
        sm[p.off[O_CSM] + rc] = Sm;
        sm[p.off[O_CSC] + rc] = sc;
      }
    }
    for (int k = lane; k < K; k += 32) {
      const float mu = in.mu[co + k];
      sm[p.off[O_RN] + k] = in.Rn[co + k];
      sm[p.off[O_MU] + k] = mu;
      sm[p.off[O_IMU] + k] = 1.f / (1.f + mu * mu);
      sm[p.off[O_CAC] + k] = in.conact[co + k];
    }
    // the active contacts, in slot order
    int* act = reinterpret_cast<int*>(sm + p.off[O_ACT]);
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool on = k < K && in.conact[co + k] != 0.f;
      const unsigned m = __ballot_sync(FULL, on);
      if (on) {
        int q = 0;
        while (q + 1 < p.npool && k >= p.pool_con[q + 1]) ++q;
        const int dp = p.pool_dim[q];
        const int rc = p.pool_row[q] + (k - p.pool_con[q]) * dp;
        act[nact + __popc(m & ((1u << lane) - 1u))] = k | (dp << 8) | (rc << 12);
      }
      nact += __popc(m);
    }
    const float* gM = in.M + (size_t)b * NV * NV + li * NV;
#pragma unroll
    for (int j = 0; j < NV; ++j) Mrow[j] = gM[j];
    a = in.warm[(size_t)b * NV + li];
    qs = in.qs[(size_t)b * NV + li];
  }
  __syncwarp();
  STAMP(0)

  const float* J = sm + p.off[O_J];
  float* G = sm + p.off[O_JD];  // Gram, then factor: jd and f, 2 ne >= nv^2
  float xb[NV];
  const int nlad = p.nladder + 1;  // rungs + the 0 candidate
  const int iterations = KIND == KIND_GRAM ? 1 : p.iterations;

  for (int iter = 0; iter < iterations; ++iter) {
    // z = J a - aref; forces, weights, rank-1 coefficients
#pragma unroll
    for (int j = 0; j < NV; ++j) xb[j] = __shfl_sync(FULL, a, j);
    rows_dot<NV>(J, xb, sm + p.off[O_AREF], sm + p.off[O_Z], ne, lane);
    __syncwarp();
    penalty_fw(p, sm, true, nact, lane);
    __syncwarp();
    STAMP(1)

    // grad = M (a - qs) - J^T f
    float Mda = 0.f;
    {
      const float dq = a - qs;
#pragma unroll
      for (int j = 0; j < NV; ++j) Mda += Mrow[j] * __shfl_sync(FULL, dq, j);
    }
    const float grad = Mda - jtf<NV>(p, sm, nact, lane);
    STAMP(2)

    // H = (J^T diag(w) J + U^T diag(wU) U) + M + 1e-10 I, lane li: row li
    if (GRAM == 0) gram_vpu<NV>(p, sm, nact, lane, G);
    else gram_mxu<NV>(p, sm, nact, lane, G);
    __syncwarp();
    float h[NV];
    float hd = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      h[j] = G[li * NV + j] + Mrow[j];
      if (j == li) { h[j] += 1e-10f; hd = h[j]; }
    }
    if (KIND == KIND_GRAM) {
      if (lane < NV) {
        float* out = in.H + (size_t)b * NV * NV + lane * NV;
#pragma unroll
        for (int j = 0; j < NV; ++j) out[j] = h[j];
      }
      return;
    }
    STAMP(3)

    // Cholesky, with the Levenberg retry when the first one fails
    float inv = chol_rows<NV>(h, li);
    if (!isfinite(__shfl_sync(FULL, h[NV - 1], NV - 1))) {
      float md = hd;  // max of the diagonal; NaN if any entry is NaN
      for (int o = 16; o > 0; o >>= 1) {
        const float other = __shfl_xor_sync(FULL, md, o);
        md = (other > md || isnan(other)) ? other : md;
      }
      const float shift = 1e-3f * md;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        h[j] = G[li * NV + j] + Mrow[j];
        if (j == li) { h[j] += 1e-10f; h[j] += shift; }
      }
      inv = chol_rows<NV>(h, li);
    }
    // delta = -(L L^T)^{-1} grad: forward in registers, back through a
    // transposed read of L in shared memory; 1/L_ii is the pivot
    float y = lane < NV ? grad : 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane == i) y = y * inv;
      const float yi = __shfl_sync(FULL, y, i);
      if (lane > i && lane < NV) y -= h[i] * yi;
    }
    __syncwarp();
    if (lane < NV) {
#pragma unroll
      for (int j = 0; j < NV; ++j) G[lane * NV + j] = h[j];
    }
    __syncwarp();
#pragma unroll
    for (int i = NV - 1; i >= 0; --i) {
      if (lane == i) y = y * inv;
      const float xi = __shfl_sync(FULL, y, i);
      if (lane < i) y -= G[i * NV + lane] * xi;
    }
    float delta = -y;
    const bool bad = (lane < NV) && !isfinite(delta);
    if (__any_sync(FULL, bad) || lane >= NV) delta = 0.f;
    __syncwarp();
    STAMP(4)

    // Jd = J delta, Md = M delta; qa = 1/2 d.Md, qb = d.Mda
#pragma unroll
    for (int j = 0; j < NV; ++j) xb[j] = __shfl_sync(FULL, delta, j);
    rows_dot<NV>(J, xb, nullptr, sm + p.off[O_JD], ne, lane);
    float Md = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) Md += Mrow[j] * xb[j];
    const float qa = 0.5f * warp_sum(lane < NV ? delta * Md : 0.f);
    const float qb = warp_sum(lane < NV ? delta * Mda : 0.f);
    __syncwarp();
    STAMP(5)

    // ladder: candidate c = lane (lanes past the ladder repeat the 0)
    float phi;
    {
      const float al = p.ladder[lane < nlad ? lane : p.nladder];
      const float* z = sm + p.off[O_Z];
      const float* jd = sm + p.off[O_JD];
      const int* act = reinterpret_cast<const int*>(sm + p.off[O_ACT]);
      float S = 0.f;
#pragma unroll 4
      for (int r = 0; r < p.nf; ++r) S += fric_S(p, sm, r, z[r] + al * jd[r]);
#pragma unroll 4
      for (int r = p.nf; r < nfl; ++r) S += lim_S(p, sm, r, z[r] + al * jd[r]);
      for (int i = 0; i < nact; ++i) {
        int k, dp, rc;
        unpack_act(act[i], k, dp, rc);
        S += con_S(p, sm, k, rc, nfl + rc, dp, al);
      }
      const float pk = al * qb + (al * al) * qa + S;
      phi = (lane < nlad && !isnan(pk)) ? pk : INFINITY;
    }
    STAMP(6)

    // first minimum over the candidates, then the parabolic vertex
    float best_phi = phi;
    int best = lane < nlad ? lane : 32;
    for (int o = 16; o > 0; o >>= 1) {
      const float op = __shfl_xor_sync(FULL, best_phi, o);
      const int oi = __shfl_xor_sync(FULL, best, o);
      if (op < best_phi || (op == best_phi && oi < best)) { best_phi = op; best = oi; }
    }
    float alpha;
    {
      const float a_best = p.ladder[best];
      const int il = best < 1 ? 1 : (best > p.nladder - 1 ? p.nladder - 1 : best);
      const float a_lo = p.ladder[il - 1], a_mid = p.ladder[il], a_hi = p.ladder[il + 1];
      const float p_lo = __shfl_sync(FULL, phi, il - 1);
      const float p_mid = __shfl_sync(FULL, phi, il);
      const float p_hi = __shfl_sync(FULL, phi, il + 1);
      const float d_lo = (p_lo - p_mid) / fmaxf(a_lo - a_mid, 1e-30f);
      const float d_hi = (p_mid - p_hi) / (fabsf(a_mid - a_hi) > 0.f ? a_mid - a_hi : 1e-30f);
      const float curv = (d_lo - d_hi) / fmaxf(a_lo - a_hi, 1e-30f);
      float vertex = 0.5f * (a_lo + a_mid) - 0.5f * d_lo / (curv > 1e-30f ? curv : 1e30f);
      vertex = clampf_nan(vertex, 0.f, 4.f);
      // S(vertex): lanes over rows, then over the active contacts
      const float* z = sm + p.off[O_Z];
      const float* jd = sm + p.off[O_JD];
      const int* act = reinterpret_cast<const int*>(sm + p.off[O_ACT]);
      float Sv = 0.f;
      for (int r = lane; r < nfl; r += 32)
        Sv += r < p.nf ? fric_S(p, sm, r, z[r] + vertex * jd[r])
                       : lim_S(p, sm, r, z[r] + vertex * jd[r]);
      for (int i = lane; i < nact; i += 32) {
        int k, dp, rc;
        unpack_act(act[i], k, dp, rc);
        Sv += con_S(p, sm, k, rc, nfl + rc, dp, vertex);
      }
      Sv = warp_sum(Sv);
      const float phi_v = vertex * qb + vertex * vertex * qa + Sv;
      alpha = phi_v < best_phi ? vertex : a_best;
    }
    STAMP(7)

    a = a + alpha * delta;
    __syncwarp();
    STAMP(8)
  }

  // final forces at the solution
#pragma unroll
  for (int j = 0; j < NV; ++j) xb[j] = __shfl_sync(FULL, a, j);
  rows_dot<NV>(J, xb, sm + p.off[O_AREF], sm + p.off[O_Z], ne, lane);
  __syncwarp();
  penalty_fw(p, sm, false, nact, lane);
  __syncwarp();
  const float qfrc = jtf<NV>(p, sm, nact, lane);
  // f: the rows of inactive slots are 0
  const float* f = sm + p.off[O_F];
  for (int r = lane; r < ne; r += 32) {
    float fr = f[r];
    if (r >= nfl) {
      const int rc = r - nfl;
      int q = 0;
      while (q + 1 < p.npool && rc >= p.pool_row[q + 1]) ++q;
      const int k = p.pool_con[q] + (rc - p.pool_row[q]) / p.pool_dim[q];
      if (sm[p.off[O_CAC] + k] == 0.f) fr = 0.f;
    }
    in.f[(size_t)b * ne + r] = fr;
  }
  if (lane < NV) {
    in.qacc[(size_t)b * NV + lane] = a;
    in.qfrc[(size_t)b * NV + lane] = qfrc;
  }
  if (KIND == KIND_PROFILE && lane == 0) {
    long long* out = in.prof + (size_t)b * (NPHASE + 1);
#pragma unroll
    for (int i = 0; i < NPHASE; ++i) out[i] = (long long)cyc[i];
    out[NPHASE] = clock64() - t_start;
  }
}

typedef void (*kernel_fn)(Params, Inputs);

// The kernel for (nv, gram_mode, kind); nullptr for a width that is not
// instantiated: only nv = 18 (Go1, Go2) is.
static kernel_fn pick(int nv, int gram_mode, int kind) {
  if (nv != 18 || gram_mode < 0 || gram_mode > 1 || kind < 0 || kind > 2)
    return nullptr;
  if (gram_mode == 0) {
    if (kind == KIND_SOLVE) return newton_kernel<18, 0, KIND_SOLVE>;
    if (kind == KIND_PROFILE) return newton_kernel<18, 0, KIND_PROFILE>;
    return newton_kernel<18, 0, KIND_GRAM>;
  }
  if (kind == KIND_SOLVE) return newton_kernel<18, 1, KIND_SOLVE>;
  if (kind == KIND_PROFILE) return newton_kernel<18, 1, KIND_PROFILE>;
  return newton_kernel<18, 1, KIND_GRAM>;
}

// The offsets (floats) of one env's arrays in the order of the O_* enum,
// and the floats per env, a multiple of 4 (16 bytes) so that every env's
// J starts 16-byte aligned.
static void env_layout(Params& p, int nv, int ncr) {
  const int nfl = p.nf + p.nl, ne = p.ne, K = p.K;
  const int size[NOFF] = {ne * nv, ne, ne, ne, ne, nfl, nfl, p.nf, p.nf,
                          p.nl, ncr, ncr, ncr, ncr, K, K, K, K, K, K, K, K};
  int o = 0;
  for (int i = 0; i < NOFF; ++i) {
    p.off[i] = o;
    o += size[i];
  }
  p.env_floats = (o + 3) & ~3;
}

// Envs per block of the solve kernel of `gram_mode` (the profile and Gram
// entries launch the same blocks): the most envs resident per SM that
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives for blocks of 1 to
// MAX_EPB envs, the larger block on a tie.  *blocks_per_sm is the
// resident blocks at that size.
static int plan_block(Params& p, int nv, int gram_mode, int* blocks_per_sm) {
  kernel_fn kernel = pick(nv, gram_mode, KIND_SOLVE);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const size_t env_bytes = (size_t)p.env_floats * sizeof(float);
  int best = 0, best_envs = 0, best_blocks = 0;
  for (int epb = MAX_EPB; epb >= 1; --epb) {
    const size_t smem = epb * env_bytes;
    if (smem > (size_t)optin) continue;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        32 * epb, smem);
    if (e != cudaSuccess) return (int)e;
    if (blocks * epb > best_envs) {
      best = epb;
      best_envs = blocks * epb;
      best_blocks = blocks;
    }
  }
  if (!best) return (int)cudaErrorInvalidValue;  // no block holds one env
  p.epb = best;
  *blocks_per_sm = best_blocks;
  return 0;
}

// The layout part of a launch's Params: the pools, the per-env shared
// layout and the envs per block.  cudaErrorInvalidValue for a layout the
// kernel cannot hold: 1 to MAX_POOLS pools of condim 1-6, fewer than 256
// slots and 2^19 contact rows (the active list packs them), 2 ne >= nv^2
// (jd and f hold the Gram).
static int make_params(Params& p, int nv, int nf, int nl, int npool,
                       const int* pool_k, const int* pool_dim, int gram_mode,
                       int* blocks_per_sm) {
  if (!pick(nv, gram_mode, KIND_SOLVE) || npool < 1 || npool > MAX_POOLS ||
      nf < 0 || nl < 0)
    return (int)cudaErrorInvalidValue;
  p.nf = nf; p.nl = nl; p.npool = npool;
  int row = 0, con = 0;
  for (int q = 0; q < npool; ++q) {
    if (pool_dim[q] < 1 || pool_dim[q] > 6 || pool_k[q] < 0)
      return (int)cudaErrorInvalidValue;
    p.pool_k[q] = pool_k[q];
    p.pool_dim[q] = pool_dim[q];
    p.pool_row[q] = row;
    p.pool_con[q] = con;
    row += pool_k[q] * pool_dim[q];
    con += pool_k[q];
  }
  p.ne = nf + nl + row;
  p.K = con;
  if (con >= 256 || row >= (1 << 19) || 2 * p.ne < nv * nv)
    return (int)cudaErrorInvalidValue;
  env_layout(p, nv, row);
  return plan_block(p, nv, gram_mode, blocks_per_sm);
}

static int launch(int kind, const float* const* x, float* qacc, float* f,
                  float* qfrc, int B, int nv, int nf, int nl, int npool,
                  const int* pool_k, const int* pool_dim, int iterations,
                  const float* ladder, int nladder, int gram_mode,
                  void* stream, long long* prof, float* H) {
  kernel_fn kernel = pick(nv, gram_mode, kind);
  if (!kernel || nladder < 2 || nladder > MAX_LADDER || iterations < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Params p;
  int blocks_per_sm = 0;
  int err = make_params(p, nv, nf, nl, npool, pool_k, pool_dim, gram_mode,
                        &blocks_per_sm);
  if (err) return err;
  p.B = B;
  p.iterations = iterations;
  p.nladder = nladder;
  for (int c = 0; c < nladder; ++c) p.ladder[c] = ladder[c];
  p.ladder[nladder] = 0.f;
  const size_t smem = (size_t)p.epb * p.env_floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  Inputs in{x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8], x[9],
            x[10], x[11], x[12], x[13], x[14], qacc, f, qfrc, prof, H};
  const int blocks = (B + p.epb - 1) / p.epb;
  kernel<<<blocks, 32 * p.epb, smem, (cudaStream_t)stream>>>(p, in);
  return (int)cudaGetLastError();
}

// Plain C entry points (bound with ctypes).  pool_k, pool_dim and ladder
// are host arrays; every other pointer is device memory, batch-first and
// contiguous float32: M, qs, warm, J, aref, D, R, floss, active, scale,
// fscale, maskd, conact, Rn, mu (ops/newton.py's order).  gram_mode: 0 =
// "vpu", 1 = "mxu".  Each launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for an nv other than 18 or
// a layout make_params refuses.
#define SOLVE_ARGS                                                           \
  const float *M, const float *qs, const float *warm, const float *J,        \
      const float *aref, const float *D, const float *R, const float *floss, \
      const float *active, const float *scale, const float *fscale,          \
      const float *maskd, const float *conact, const float *Rn,              \
      const float *mu
#define SOLVE_PTRS                                                          \
  {M, qs, warm, J, aref, D, R, floss, active, scale, fscale, maskd, conact, \
   Rn, mu}

extern "C" int newton_solve_f32(SOLVE_ARGS, float* qacc, float* f, float* qfrc,
                                int B, int nv, int nf, int nl, int npool,
                                const int* pool_k, const int* pool_dim,
                                int iterations, const float* ladder,
                                int nladder, int gram_mode, void* stream) {
  const float* x[15] = SOLVE_PTRS;
  return launch(KIND_SOLVE, x, qacc, f, qfrc, B, nv, nf, nl, npool, pool_k,
                pool_dim, iterations, ladder, nladder, gram_mode, stream,
                nullptr, nullptr);
}

// The same solve with SM clock stamps at the phase boundaries (after a
// __syncwarp): prof (B, NPHASE + 1) int64, per env the cycles of each
// phase summed over the iterations, then the whole solve.  Off the main
// path.
extern "C" int newton_profile_f32(SOLVE_ARGS, float* qacc, float* f,
                                  float* qfrc, int B, int nv, int nf, int nl,
                                  int npool, const int* pool_k,
                                  const int* pool_dim, int iterations,
                                  const float* ladder, int nladder,
                                  int gram_mode, void* stream,
                                  long long* prof) {
  if (!prof) return (int)cudaErrorInvalidValue;
  const float* x[15] = SOLVE_PTRS;
  return launch(KIND_PROFILE, x, qacc, f, qfrc, B, nv, nf, nl, npool, pool_k,
                pool_dim, iterations, ladder, nladder, gram_mode, stream,
                prof, nullptr);
}

// H of the first iteration (at the warm start) alone, through the same
// staging, penalty and Gram device code as the solve: H (B, nv, nv).  Off
// the main path: it lets a test hold each mode's Gram against a float64
// reference, apart from the line search.
extern "C" int newton_gram_f32(SOLVE_ARGS, float* H, int B, int nv, int nf,
                               int nl, int npool, const int* pool_k,
                               const int* pool_dim, const float* ladder,
                               int nladder, int gram_mode, void* stream) {
  const float* x[15] = SOLVE_PTRS;
  return launch(KIND_GRAM, x, nullptr, nullptr, nullptr, B, nv, nf, nl, npool,
                pool_k, pool_dim, 1, ladder, nladder, gram_mode, stream,
                nullptr, H);
}

// The solve kernel's launch plan and resources for a layout, as
// make_params computes them: out = {envs per block, bytes of shared
// memory per env, resident blocks per SM, registers per thread, local
// (spill) bytes per thread}.
extern "C" int newton_resources(int nv, int gram_mode, int nf, int nl,
                                int npool, const int* pool_k,
                                const int* pool_dim, int* out) {
  Params p;
  int blocks = 0;
  int err = make_params(p, nv, nf, nl, npool, pool_k, pool_dim, gram_mode,
                        &blocks);
  if (err) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, pick(nv, gram_mode, KIND_SOLVE));
  if (e != cudaSuccess) return (int)e;
  out[0] = p.epb;
  out[1] = p.env_floats * (int)sizeof(float);
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}
