// Batched Newton solve of MuJoCo's soft-constraint problem, for Hopper.
//
// Replaces the Pallas TPU kernel quadruped_tpu/ops/newton.py
// (_newton_solve_jit -> pl.pallas_call, body newton_core, gram_mode
// "vpu").  Same function, per env: warm-started primal Newton on
//   Phi(a) = 1/2 |a - a_smooth|_M^2 + sum_i s_i(J a - aref)
// with Huber dof-friction rows, one-sided limit rows and elliptic cones
// per condim pool; H = M + J^T diag(w) J + 3 rank-1 cone rows per friction
// contact + 1e-10 I; an nv x nv Cholesky with a 1e-3*maxdiag Levenberg
// retry and a zero step if both factorizations fail; a ladder line search
// (NaN-safe argmin) with one parabolic refinement.  Outputs qacc, the row
// forces f and qfrc = J^T f.
//
// What bounds it: FP32 arithmetic, not bytes.  At the configuration of
// record (nv 18, 168 rows, 48 contacts, 8 iterations) an env does about
// 1.2 MFLOP per solve on 13 KB of inputs, ~90 FLOP per byte, far above
// the card's FP32/bandwidth ratio (~20).  The Gram (171 upper pairs x 276
// weighted rows) and the 18 penalty evaluations of the line search are
// the bulk of it.
//
// Design: one thread block per env (the TPU kernel put 128 envs on the
// lane axis instead).  The env's J and M are staged into shared memory
// once and stay there across all iterations and line-search candidates,
// as VMEM held them on the TPU, so the solve reads device memory once.
// Threads spread over rows for z, f and w, over contacts for the cone
// zones and rank-1 rows, over the upper-triangle (i, j) pairs for the
// Gram; one warp factors and solves the nv x nv system (a lane per row);
// each warp evaluates whole ladder candidates with lanes over rows and
// contacts, so every reduction is a warp shuffle in a fixed order and the
// result is deterministic.  The TPU kernel's edge padding of the batch to
// 128 lanes has no counterpart: the grid has exactly one block per env.
//
// Built without --use_fast_math: the solve depends on IEEE semantics (a
// negative pivot gives NaN, which triggers the Levenberg retry; NaN line
// search candidates lose the argmin; non-finite steps are zeroed).

#include <cuda_runtime.h>
#include <math.h>

#define NTHREADS 128
#define NWARPS (NTHREADS / 32)
#define MAX_NV 32
#define MAX_POOLS 4
#define MAX_LADDER 32
#define FULL 0xffffffffu

struct Params {
  int B, nv, nf, nl, ne, ktot, npool, iterations, nladder, nu;
  int pool_k[MAX_POOLS], pool_dim[MAX_POOLS];
  int pool_row[MAX_POOLS], pool_con[MAX_POOLS], pool_u[MAX_POOLS];
  float ladder[MAX_LADDER + 1];  // nladder rungs, then 0
};

struct Inputs {
  const float *M, *qs, *warm, *J, *aref, *D, *R, *floss, *active;
  const float *scale, *fscale, *maskd, *conact, *Rn, *mu;
  float *qacc, *f, *qfrc;
};

// shared-memory layout, in floats
struct Layout {
  int J, M, H, L, U, wU, aref, D, R, fl, act, z, Jd, f, w;
  int sc, fsc, mk, Rn, mu, cac, vec, phis, total;
};

__host__ __device__ inline Layout make_layout(const Params& p) {
  Layout s;
  int o = 0;
  int nv2 = p.nv * p.nv;
  s.J = o; o += p.ne * p.nv;
  s.M = o; o += nv2;
  s.H = o; o += nv2;
  s.L = o; o += nv2;
  s.U = o; o += p.nu * p.nv;
  s.wU = o; o += p.nu;
  s.aref = o; o += p.ne;
  s.D = o; o += p.ne;
  s.R = o; o += p.ne;
  s.fl = o; o += p.ne;
  s.act = o; o += p.ne;
  s.z = o; o += p.ne;
  s.Jd = o; o += p.ne;
  s.f = o; o += p.ne;
  s.w = o; o += p.ne;
  s.sc = o; o += p.ktot * 6;
  s.fsc = o; o += p.ktot * 6;
  s.mk = o; o += p.ktot * 6;
  s.Rn = o; o += p.ktot;
  s.mu = o; o += p.ktot;
  s.cac = o; o += p.ktot;
  s.vec = o; o += 8 * MAX_NV;  // a, qs, Mda, grad, delta, Md, scratch x2
  s.phis = o; o += MAX_LADDER + 8;
  s.total = o;
  return s;
}

// vec slots
#define V_A 0
#define V_QS 1
#define V_MDA 2
#define V_GRAD 3
#define V_DELTA 4
#define V_MD 5
// phis slots after the ladder: scalars
#define S_QA 0
#define S_QB 1
#define S_ALPHA 2

__device__ inline float clampf_nan(float x, float lo, float hi) {
  // jnp.clip semantics: NaN stays NaN
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// pool of contact k: returns p and fills (kk, dim, first row, U base)
__device__ inline int pool_of(const Params& p, int k, int& kk, int& dp,
                              int& row, int& ubase) {
  int q = 0;
  while (q + 1 < p.npool && k >= p.pool_con[q + 1]) ++q;
  kk = k - p.pool_con[q];
  dp = p.pool_dim[q];
  row = p.nf + p.nl + p.pool_row[q] + kk * dp;
  ubase = p.pool_u[q];
  return q;
}

// penalty of a dof-friction or limit row r at z
__device__ inline float row_S(const Params& p, const float* sm, const Layout& L,
                              int r, float z) {
  float Dr = sm[L.D + r];
  if (r < p.nf) {
    float fl = sm[L.fl + r];
    bool quad = fabsf(Dr * z) <= fl;
    return quad ? 0.5f * Dr * z * z
                : fl * fabsf(z) - 0.5f * fl * fl * sm[L.R + r];
  }
  bool act = (sm[L.act + r] > 0.f) && (z < 0.f);
  return act ? 0.5f * Dr * z * z : 0.f;
}

// cone penalty of contact k at rows z0 + alpha * dz
__device__ inline float con_S(const Params& p, const float* sm, const Layout& L,
                              int k, const float* z0, const float* dz,
                              float alpha) {
  int kk, dp, row, ub;
  pool_of(p, k, kk, dp, row, ub);
  float Rn = sm[L.Rn + k], mu = sm[L.mu + k];
  float u0 = 0.f, tt = 0.f;
  for (int d = 0; d < dp; ++d) {
    float z = z0[row + d] + alpha * dz[row + d];
    float u = -(z * sm[L.sc + k * 6 + d] * sm[L.mk + k * 6 + d]) / Rn;
    if (d == 0) u0 = u; else tt += u * u;
  }
  float t = sqrtf(tt + 1e-30f);
  bool bottom = t <= mu * u0;
  bool top = mu * t <= -u0;
  float usq = u0 * u0 + tt;
  float al = (u0 + mu * t) / (1.f + mu * mu);
  float mid_d2 = usq - al * al * (1.f + mu * mu);
  float d2 = bottom ? 0.f : (top ? usq : mid_d2);
  return 0.5f * Rn * (usq - d2);
}

// total penalty S(z + alpha * dz), one warp, lanes over rows and contacts
__device__ inline float warp_S(const Params& p, const float* sm, const Layout& L,
                               float alpha, int lane) {
  const float* z = sm + L.z;
  const float* dz = sm + L.Jd;
  int nfl = p.nf + p.nl;
  float acc = 0.f;
  for (int it = lane; it < nfl + p.ktot; it += 32) {
    if (it < nfl) acc += row_S(p, sm, L, it, z[it] + alpha * dz[it]);
    else acc += con_S(p, sm, L, it - nfl, z, dz, alpha);
  }
  return warp_sum(acc);
}

// forces f(z) and weights w(z) of every row; with want_u, also the
// rank-1 cone rows U and their weights wU (friction contacts)
__device__ void penalty_fw(const Params& p, float* sm, const Layout& L,
                           bool want_u, int tid) {
  const float* z = sm + L.z;
  int nfl = p.nf + p.nl;
  for (int r = tid; r < nfl; r += NTHREADS) {
    float Dr = sm[L.D + r], zr = z[r];
    float fr, wr;
    if (r < p.nf) {
      float fl = sm[L.fl + r];
      float f_unc = -Dr * zr;
      bool quad = fabsf(f_unc) <= fl;
      fr = clampf_nan(f_unc, -fl, fl);
      wr = quad ? Dr : 0.f;
    } else {
      bool act = (sm[L.act + r] > 0.f) && (zr < 0.f);
      fr = act ? -Dr * zr : 0.f;
      wr = act ? Dr : 0.f;
    }
    sm[L.f + r] = fr;
    sm[L.w + r] = wr;
  }
  for (int k = tid; k < p.ktot; k += NTHREADS) {
    int kk, dp, row, ub;
    int q = pool_of(p, k, kk, dp, row, ub);
    float Rn = sm[L.Rn + k], mu = sm[L.mu + k], cac = sm[L.cac + k];
    float u[6];
    float tt = 0.f;
    for (int d = 0; d < dp; ++d) {
      u[d] = -(z[row + d] * sm[L.sc + k * 6 + d] * sm[L.mk + k * 6 + d]) / Rn;
      if (d > 0) tt += u[d] * u[d];
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
    for (int d = 0; d < dp; ++d) {
      float phi = phi0;
      if (d > 0) {
        float tdir = u[d] / t;
        phi = bottom ? u[d] : (top ? 0.f : mu * al * tdir);
      }
      float sc = sm[L.sc + k * 6 + d], mk = sm[L.mk + k * 6 + d];
      sm[L.f + row + d] = phi * sm[L.fsc + k * 6 + d] * mk;
      sm[L.w + row + d] = (diag_c * cac / Rn) * sc * sc * mk;
    }
    if (want_u && dp > 1) {
      // U_e0 = (S e0)^T Jc, U_n = (S nhat)^T Jc, U_v = U_e0 + mu U_n
      int Kp = p.pool_k[q];
      float* Uv = sm + L.U + (ub + kk) * p.nv;
      float* Ue = sm + L.U + (ub + Kp + kk) * p.nv;
      float* Un = sm + L.U + (ub + 2 * Kp + kk) * p.nv;
      const float* Jc = sm + L.J + row * p.nv;
      float Sm0 = sm[L.sc + k * 6] * sm[L.mk + k * 6];
      float cn[6];
      for (int d = 1; d < dp; ++d)
        cn[d] = (sm[L.sc + k * 6 + d] * sm[L.mk + k * 6 + d]) * (u[d] / t);
      for (int i = 0; i < p.nv; ++i) {
        float e0 = Sm0 * Jc[i];
        float n = cn[1] * Jc[p.nv + i];
        for (int d = 2; d < dp; ++d) n = n + cn[d] * Jc[d * p.nv + i];
        Ue[i] = e0;
        Un[i] = n;
        Uv[i] = e0 + mu * n;
      }
      float is_mid = (middle ? 1.f : 0.f) * cac;
      float wVn = -is_mid * mid_c / Rn;
      sm[L.wU + ub + kk] = is_mid / ((1.f + mu * mu) * Rn);
      sm[L.wU + ub + Kp + kk] = wVn;
      sm[L.wU + ub + 2 * Kp + kk] = wVn;
    }
  }
}

// out[i] = sum_r J[r, i] * v[r]: warps over columns, lanes over rows
__device__ inline void rmatvec(const Params& p, const float* sm, const Layout& L,
                               const float* v, float* out, int warp, int lane) {
  for (int i = warp; i < p.nv; i += NWARPS) {
    float acc = 0.f;
    for (int r = lane; r < p.ne; r += 32) acc += sm[L.J + r * p.nv + i] * v[r];
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

// out[r] = sum_i J[r, i] * x[i] (+ sub), threads over rows
__device__ inline void matvec_rows(const Params& p, const float* sm,
                                   const Layout& L, const float* x,
                                   const float* sub, float* out, int tid) {
  for (int r = tid; r < p.ne; r += NTHREADS) {
    const float* Jr = sm + L.J + r * p.nv;
    float acc = Jr[0] * x[0];
    for (int i = 1; i < p.nv; ++i) acc = acc + Jr[i] * x[i];
    out[r] = sub ? acc - sub[r] : acc;
  }
}

// in-place right-looking Cholesky of W (nv x nv, lower part used) by one
// warp, lane = row; 1/sqrtf gives NaN on a negative pivot
__device__ inline void warp_cholesky(float* W, int nv, int lane) {
  for (int j = 0; j < nv; ++j) {
    float pivot = 1.f / sqrtf(W[j * nv + j]);
    __syncwarp();
    float col = 0.f;
    if (lane < nv && lane >= j) col = W[lane * nv + j] * pivot;
    __syncwarp();
    if (lane < nv && lane >= j) W[lane * nv + j] = col;
    __syncwarp();
    if (lane < nv && lane > j)
      for (int k = j + 1; k <= lane; ++k) W[lane * nv + k] -= col * W[k * nv + j];
    __syncwarp();
  }
}

extern "C" __global__ void __launch_bounds__(NTHREADS)
newton_kernel(Params p, Inputs in) {
  extern __shared__ float sm[];
  const Layout L = make_layout(p);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = p.nv, ne = p.ne, nv2 = nv * nv;
  float* vec = sm + L.vec;
  float* a = vec + V_A * MAX_NV;
  float* qs = vec + V_QS * MAX_NV;
  float* Mda = vec + V_MDA * MAX_NV;
  float* grad = vec + V_GRAD * MAX_NV;
  float* delta = vec + V_DELTA * MAX_NV;
  float* Md = vec + V_MD * MAX_NV;
  float* phis = sm + L.phis;
  float* scal = phis + MAX_LADDER + 2;

  // ---- stage this env's inputs in shared memory -----------------------
  {
    const float* gJ = in.J + (size_t)b * ne * nv;
    for (int i = tid; i < ne * nv; i += NTHREADS) sm[L.J + i] = gJ[i];
    const float* gM = in.M + (size_t)b * nv2;
    for (int i = tid; i < nv2; i += NTHREADS) sm[L.M + i] = gM[i];
    size_t ro = (size_t)b * ne;
    for (int r = tid; r < ne; r += NTHREADS) {
      sm[L.aref + r] = in.aref[ro + r];
      sm[L.D + r] = in.D[ro + r];
      sm[L.R + r] = in.R[ro + r];
      sm[L.fl + r] = in.floss[ro + r];
      sm[L.act + r] = in.active[ro + r];
    }
    size_t co = (size_t)b * p.ktot;
    for (int i = tid; i < p.ktot * 6; i += NTHREADS) {
      int k = i / 6;
      sm[L.sc + i] = in.scale[co * 6 + i];
      sm[L.fsc + i] = in.fscale[co * 6 + i];
      sm[L.mk + i] = in.maskd[co * 6 + i] * in.conact[co + k];
    }
    for (int k = tid; k < p.ktot; k += NTHREADS) {
      sm[L.Rn + k] = in.Rn[co + k];
      sm[L.mu + k] = in.mu[co + k];
      sm[L.cac + k] = in.conact[co + k];
    }
    for (int i = tid; i < nv; i += NTHREADS) {
      a[i] = in.warm[(size_t)b * nv + i];
      qs[i] = in.qs[(size_t)b * nv + i];
    }
  }
  __syncthreads();

  const int npairs = nv * (nv + 1) / 2;
  const int nlad = p.nladder + 1;  // rungs + the 0 candidate

  for (int iter = 0; iter < p.iterations; ++iter) {
    // z = J a - aref
    matvec_rows(p, sm, L, a, sm + L.aref, sm + L.z, tid);
    __syncthreads();
    penalty_fw(p, sm, L, true, tid);
    for (int i = tid; i < nv; i += NTHREADS) {
      float acc = 0.f;
      for (int j = 0; j < nv; ++j) acc += sm[L.M + i * nv + j] * (a[j] - qs[j]);
      Mda[i] = acc;
    }
    __syncthreads();
    // grad = M (a - qs) - J^T f
    rmatvec(p, sm, L, sm + L.f, grad, warp, lane);
    // H = M + J^T diag(w) J + U^T diag(wU) U + 1e-10 I, upper pairs
    for (int pr = tid; pr < npairs; pr += NTHREADS) {
      int i = 0, rem = pr;
      while (rem >= nv - i) { rem -= nv - i; ++i; }
      int j = i + rem;
      float hj = 0.f;
      for (int r = 0; r < ne; ++r) {
        const float* Jr = sm + L.J + r * nv;
        hj += Jr[i] * sm[L.w + r] * Jr[j];
      }
      float hu = 0.f;
      for (int u = 0; u < p.nu; ++u) {
        const float* Ur = sm + L.U + u * nv;
        hu += Ur[i] * sm[L.wU + u] * Ur[j];
      }
      float h = (hj + hu) + sm[L.M + i * nv + j];
      if (i == j) h += 1e-10f;
      sm[L.H + i * nv + j] = h;
      sm[L.H + j * nv + i] = h;
    }
    __syncthreads();
    if (warp == 0) {
      for (int i = lane; i < nv; i += 32) grad[i] = Mda[i] - grad[i];
      float* W = sm + L.L;
      const float* H = sm + L.H;
      for (int i = lane; i < nv2; i += 32) W[i] = H[i];
      __syncwarp();
      warp_cholesky(W, nv, lane);
      if (!isfinite(W[nv2 - 1])) {
        // Levenberg retry with 1e-3 * max diag
        float md = H[0];
        for (int i = 1; i < nv; ++i) {
          float d = H[i * nv + i];
          md = (d > md || isnan(d)) ? d : md;
        }
        float shift = 1e-3f * md;
        __syncwarp();
        for (int i = lane; i < nv2; i += 32)
          W[i] = H[i] + ((i / nv == i % nv) ? shift : 0.f);
        __syncwarp();
        warp_cholesky(W, nv, lane);
      }
      // delta = -(L L^T)^{-1} grad, lane i holds row i
      float y = lane < nv ? grad[lane] : 0.f;
      for (int i = 0; i < nv; ++i) {
        if (lane == i) y = y / W[i * nv + i];
        float yi = __shfl_sync(FULL, y, i);
        if (lane > i && lane < nv) y -= W[lane * nv + i] * yi;
      }
      for (int i = nv - 1; i >= 0; --i) {
        if (lane == i) y = y / W[i * nv + i];
        float xi = __shfl_sync(FULL, y, i);
        if (lane < i) y -= W[i * nv + lane] * xi;
      }
      float dl = -y;
      bool bad = (lane < nv) && !isfinite(dl);
      if (__any_sync(FULL, bad)) dl = 0.f;
      if (lane < nv) delta[lane] = dl;
    }
    __syncthreads();
    // Jd = J delta, Md = M delta
    matvec_rows(p, sm, L, delta, nullptr, sm + L.Jd, tid);
    for (int i = tid; i < nv; i += NTHREADS) {
      float acc = 0.f;
      for (int j = 0; j < nv; ++j) acc += sm[L.M + i * nv + j] * delta[j];
      Md[i] = acc;
    }
    __syncthreads();
    if (warp == 0) {
      float qa = lane < nv ? delta[lane] * Md[lane] : 0.f;
      float qb = lane < nv ? delta[lane] * Mda[lane] : 0.f;
      qa = 0.5f * warp_sum(qa);
      qb = warp_sum(qb);
      if (lane == 0) { scal[S_QA] = qa; scal[S_QB] = qb; }
    }
    __syncthreads();
    // line search: each warp evaluates whole ladder candidates
    {
      float qa = scal[S_QA], qb = scal[S_QB];
      for (int c = warp; c < nlad; c += NWARPS) {
        float al = p.ladder[c];
        float S = warp_S(p, sm, L, al, lane);
        if (lane == 0) {
          float pk = al * qb + (al * al) * qa + S;
          phis[c] = isnan(pk) ? INFINITY : pk;
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      float qa = scal[S_QA], qb = scal[S_QB];
      int best = 0;
      float best_phi = phis[0];
      for (int c = 1; c < nlad; ++c)
        if (phis[c] < best_phi) { best_phi = phis[c]; best = c; }
      float a_best = p.ladder[best];
      int il = best < 1 ? 1 : (best > p.nladder - 1 ? p.nladder - 1 : best);
      float a_lo = p.ladder[il - 1], a_mid = p.ladder[il], a_hi = p.ladder[il + 1];
      float p_lo = phis[il - 1], p_mid = phis[il], p_hi = phis[il + 1];
      float d_lo = (p_lo - p_mid) / fmaxf(a_lo - a_mid, 1e-30f);
      float d_hi = (p_mid - p_hi) / (fabsf(a_mid - a_hi) > 0.f ? a_mid - a_hi : 1e-30f);
      float curv = (d_lo - d_hi) / fmaxf(a_lo - a_hi, 1e-30f);
      float vertex = 0.5f * (a_lo + a_mid) - 0.5f * d_lo / (curv > 1e-30f ? curv : 1e30f);
      vertex = clampf_nan(vertex, 0.f, 4.f);
      float Sv = warp_S(p, sm, L, vertex, lane);
      if (lane == 0) {
        float phi_v = vertex * qb + vertex * vertex * qa + Sv;
        scal[S_ALPHA] = phi_v < best_phi ? vertex : a_best;
      }
    }
    __syncthreads();
    for (int i = tid; i < nv; i += NTHREADS) a[i] = a[i] + scal[S_ALPHA] * delta[i];
    __syncthreads();
  }

  // final forces at the solution
  matvec_rows(p, sm, L, a, sm + L.aref, sm + L.z, tid);
  __syncthreads();
  penalty_fw(p, sm, L, false, tid);
  __syncthreads();
  rmatvec(p, sm, L, sm + L.f, Md, warp, lane);
  __syncthreads();
  for (int r = tid; r < ne; r += NTHREADS) in.f[(size_t)b * ne + r] = sm[L.f + r];
  for (int i = tid; i < nv; i += NTHREADS) {
    in.qacc[(size_t)b * nv + i] = a[i];
    in.qfrc[(size_t)b * nv + i] = Md[i];
  }
}

// Plain C entry point (bound with ctypes).  pool_k, pool_dim and ladder
// are host arrays; every other pointer is device memory, batch-first and
// contiguous float32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int newton_solve_f32(
    const float* M, const float* qs, const float* warm, const float* J,
    const float* aref, const float* D, const float* R, const float* floss,
    const float* active, const float* scale, const float* fscale,
    const float* maskd, const float* conact, const float* Rn, const float* mu,
    float* qacc, float* f, float* qfrc, int B, int nv, int nf, int nl,
    int npool, const int* pool_k, const int* pool_dim, int iterations,
    const float* ladder, int nladder, void* stream) {
  if (B <= 0) return 0;
  if (nv < 1 || nv > MAX_NV || npool < 1 || npool > MAX_POOLS ||
      nladder < 2 || nladder > MAX_LADDER)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B; p.nv = nv; p.nf = nf; p.nl = nl; p.npool = npool;
  p.iterations = iterations; p.nladder = nladder;
  int row = 0, con = 0, u = 0;
  for (int q = 0; q < npool; ++q) {
    if (pool_dim[q] < 1 || pool_dim[q] > 6) return (int)cudaErrorInvalidValue;
    p.pool_k[q] = pool_k[q];
    p.pool_dim[q] = pool_dim[q];
    p.pool_row[q] = row;
    p.pool_con[q] = con;
    p.pool_u[q] = u;
    row += pool_k[q] * pool_dim[q];
    con += pool_k[q];
    if (pool_dim[q] > 1) u += 3 * pool_k[q];
  }
  p.ne = nf + nl + row;
  p.ktot = con;
  p.nu = u;
  for (int c = 0; c < nladder; ++c) p.ladder[c] = ladder[c];
  p.ladder[nladder] = 0.f;
  Layout L = make_layout(p);
  size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  Inputs in{M, qs, warm, J, aref, D, R, floss, active, scale, fscale, maskd,
            conact, Rn, mu, qacc, f, qfrc};
  newton_kernel<<<B, NTHREADS, smem, (cudaStream_t)stream>>>(p, in);
  return (int)cudaGetLastError();
}
