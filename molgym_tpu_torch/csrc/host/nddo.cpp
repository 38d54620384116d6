// Native PM6 (NDDO) unrestricted-SCF backend — the production port of
// molgym_tpu/calculators/nddo_ref.py (the numpy oracle; see its docstring for
// the physics and the golden-value calibration story).
//
// Replaces SCINE Sparrow's PM6 role in the reference (molgym/calculator.py,
// molgym/reward.py:24-44): total energies in Hartree for neutral molecules
// with spin multiplicity (sum Z) % 2 + 1 by default. Reproduces the
// reference's golden values (tests/test_sparrow.py, tests/test_reward.py,
// tests/resources/energy.dat) to ~1e-8 Ha without scine installed.
//
// Components:
//   * STO overlap integrals via prolate-spheroidal A/B auxiliary functions
//     (exact, generic n <= 3, l <= 2).
//   * MNDO/d d shell on S: real-Gaunt-derived multipole components, analytic
//     Slater-Condon one-center spd integrals, exact 5x5 d rotations.
//   * Dewar-Thiel point-multipole two-center two-electron integrals with
//     Klopman additive radii (rho1/rho2 solved by bisection from the
//     one-center limits).
//   * UHF SCF: Householder tridiagonalization + implicit QL eigensolver,
//     Pulay DIIS on [F,P] with light early-iteration damping.
//   * PM6 core-core: pairwise (alpha, x) scaling, O-H/N-H gaussian form,
//     C-C triple-bond term, 1e-8((ZA^1/3+ZB^1/3)/R)^12 wall.
//
// Exposed C ABI (ctypes, see calculators/native.py):
//   mg_nddo_energy / mg_nddo_gradients / mg_nddo_supported /
//   mg_nddo_scf_density
// All state is per-call (thread-safe under the molgym_host.cpp pool).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

namespace nddo {

constexpr double kEvPerHartree = 27.21138602;
constexpr double kBohrPerAngstrom = 1.0 / 0.52917721067;
constexpr double kAngstromPerBohr = 0.52917721067;

// ---------------------------------------------------------------------------
// Parameters (see nddo_ref.py for provenance + golden-fit calibration notes)
// ---------------------------------------------------------------------------
struct Elem {
  int z;
  double zval;
  int n;
  double zs, zp, uss, upp, beta_s, beta_p, gss, gsp, gpp, gp2, hsp;
  bool has_p;
  // MNDO/d extension (S only; see calculators/nddo_ref.py PM6_PARAMS for
  // the calibration provenance of zd/udd/beta_d)
  bool has_d;
  double zd, udd, beta_d;
  // PM6 'internal' one-center exponent set + Slater-Condon overrides for
  // the spd integrals (f0sd/g2sd in eV, as parameterized); 0 = not set,
  // fall back to the basis exponents / analytic values — mirrors
  // nddo_ref.py _internal_zetas/_one_center_rk so the two backends cannot
  // desynchronize when an element parameterizes them.
  double zsn = 0.0, zpn = 0.0, zdn = 0.0, f0sd = 0.0, g2sd = 0.0;
};

static const Elem kElems[] = {
    {1, 1.0, 1, 1.278558908, 0.0, -11.246958, 0.0, -8.465910008, 0.0,
     14.448686, 0.0, 0.0, 0.0, 0.0, false, false, 0.0, 0.0, 0.0},
    {6, 4.0, 2, 2.047558, 1.702841, -51.089653, -39.937920, -15.385236,
     -7.471929, 13.335519, 11.528134, 10.778326, 9.486212, 0.717322, true,
     false, 0.0, 0.0, 0.0},
    {7, 5.0, 2, 2.380406, 1.999246, -57.784823, -49.893036, -17.979377,
     -15.055017, 12.357026, 9.636190, 12.570756, 10.576425, 2.871545, true,
     false, 0.0, 0.0, 0.0},
    {8, 6.0, 2, 5.421751, 2.270960, -91.678761, -70.460949, -65.635137,
     -21.622604, 11.304042, 15.807424, 13.618205, 10.332765, 5.010801, true,
     false, 0.0, 0.0, 0.0},
    {9, 7.0, 2, 6.043849, 2.906722, -140.225626, -98.778044, -69.922593,
     -30.448165, 12.446818, 18.496082, 8.417366, 13.239308, 2.853300, true,
     false, 0.0, 0.0, 0.0},
    {16, 6.0, 3, 2.192844, 1.841078, -47.531724, -39.910426, -13.827839,
     -7.685341, 9.201926, 5.004267, 8.182069, 7.304130, 1.425827, true,
     true, 1.2, -22.0, -5.0},
    // Cl (sp): MNDO element block (no golden data, no reliable PM6 recall)
    // + in-tree anchor-calibrated diatomic constants — see nddo_ref.py
    // PM6_PARAMS[17] and experiments/pm6_anchor_fit/.
    {17, 7.0, 3, 3.784645, 2.036263, -100.227166, -77.378667, -14.262320,
     -14.262320, 15.03, 13.16, 11.30, 9.97, 2.42, true,
     false, 0.0, 0.0, 0.0},
    // Br (sp, n=4): MNDO element block (Dewar & Healy 1983) + in-tree
    // anchor-calibrated diatomic constants (HBr/Br2/CH3Br) — see
    // nddo_ref.py PM6_PARAMS[35] and experiments/pm6_anchor_fit/.
    {35, 7.0, 4, 3.854302, 2.199209, -99.986441, -75.671307, -8.917107,
     -9.943740, 15.036395, 13.034682, 11.276325, 9.854426, 2.455869, true,
     false, 0.0, 0.0, 0.0},
};

static int n_orbs(const Elem& e) { return e.has_d ? 9 : (e.has_p ? 4 : 1); }

static const Elem* elem(int z) {
  for (const auto& e : kElems)
    if (e.z == z) return &e;
  return nullptr;
}

struct PairCC {
  int z1, z2;
  double alpha, x;
};

// (alpha, x): H-H and O-H Sparrow-calibrated; every other pair the
// experiment families exercise is anchor-fit in-tree against experimental
// atomization energies + bond lengths (experiments/pm6_anchor_fit/, must
// stay bit-identical to nddo_ref.py PM6_PAIR_PARAMS — the per-pair
// provenance comments live there).
static const PairCC kPairs[] = {
    {1, 1, 3.523116597, 4.535283120}, {1, 6, 2.000000, 1.282168},
    {1, 7, 0.900000, 0.388491},       {1, 8, 1.251075737, 0.384906880},
    {1, 9, 2.844553, 1.136670},       {1, 16, 2.000000, 1.456853},
    {1, 17, 2.000015, 1.012454},      {6, 6, 2.328918, 1.332038},
    {6, 7, 2.000000, 1.117268},       {6, 8, 2.000000, 0.958763},
    {6, 9, 2.253729, 0.678285},       {6, 16, 2.210533, 1.333400},
    {6, 17, 2.040729, 0.871138},      {7, 7, 2.000000, 0.962528},
    {7, 8, 2.000000, 0.931884},       {7, 9, 2.823688, 1.629597},
    {8, 8, 2.394117, 1.324384},       {8, 9, 3.003630, 1.859423},
    {8, 16, 2.000137, 1.453441},      {9, 9, 3.439433, 1.885009},
    {9, 16, 2.116469, 0.630170},      {16, 16, 1.792625, 0.959002},
    {17, 17, 2.068055, 0.901000},
    {1, 35, 2.115282, 1.238931},     {6, 35, 2.313587, 1.639005},
    {35, 35, 2.843407, 6.216140},
};

static void pair_cc(int za, int zb, double* alpha, double* x, bool* gauss_r2) {
  const int z1 = za < zb ? za : zb, z2 = za < zb ? zb : za;
  *gauss_r2 = (z1 == 1 && (z2 == 7 || z2 == 8));
  for (const auto& p : kPairs) {
    if (p.z1 == z1 && p.z2 == z2) {
      *alpha = p.alpha;
      *x = p.x;
      return;
    }
  }
  *alpha = 2.5;  // fallback for unparameterized pairs (documented approx)
  *x = 1.0;
}

// ---------------------------------------------------------------------------
// STO overlaps (prolate-spheroidal A/B method; nddo_ref.py sto_overlap)
// ---------------------------------------------------------------------------
static double factorial(int n) {
  double f = 1.0;
  for (int i = 2; i <= n; ++i) f *= i;
  return f;
}

static double sto_norm(int n, double zeta) {
  return std::pow(2.0 * zeta, n + 0.5) / std::sqrt(factorial(2 * n));
}

static void aux_a(int kmax, double p, double* a) {
  const double ep = std::exp(-p);
  a[0] = ep / p;
  for (int k = 1; k <= kmax; ++k) a[k] = (ep + k * a[k - 1]) / p;
}

static void aux_b(int kmax, double q, double* b) {
  if (std::fabs(q) < 0.35) {  // series (recursion cancels catastrophically)
    for (int k = 0; k <= kmax; ++k) {
      double total = 0.0, term = 1.0;
      int m = 0;
      for (;;) {
        if ((m + k) % 2 == 0) total += term * 2.0 / (m + k + 1);
        ++m;
        term *= -q / m;
        if (std::fabs(term) < 1e-18 && m > 4) break;
      }
      b[k] = total;
    }
    return;
  }
  const double eq = std::exp(q), emq = std::exp(-q);
  b[0] = (eq - emq) / q;
  for (int k = 1; k <= kmax; ++k)
    b[k] = (k * b[k - 1] + (k % 2 == 0 ? eq : -eq) - emq) / q;
}

// small dense polynomial in (xi, eta); degrees stay below 18 for n <= 3,
// l <= 2 (the m = 2 delta overlaps carry ((xi^2-1)(1-eta^2))^2)
struct Poly {
  double c[18][18];
  int dx, dy;  // max degree used in xi / eta
  Poly() : dx(0), dy(0) { std::memset(c, 0, sizeof(c)); }
};

static Poly poly_mul(const Poly& a, const Poly& b) {
  Poly out;
  out.dx = a.dx + b.dx;
  out.dy = a.dy + b.dy;
  for (int i = 0; i <= a.dx; ++i)
    for (int j = 0; j <= a.dy; ++j) {
      if (a.c[i][j] == 0.0) continue;
      for (int k = 0; k <= b.dx; ++k)
        for (int l = 0; l <= b.dy; ++l)
          out.c[i + k][j + l] += a.c[i][j] * b.c[k][l];
    }
  return out;
}

// P_l^m(x) = (1-x^2)^(m/2) Q_{l,m}(x), Condon-Shortley phase dropped (both
// orbitals of an equal-m pair carry it, so it cancels). Ascending powers.
static const double* assoc_q(int l, int m, int* deg) {
  static const double q00[] = {1.0};
  static const double q10[] = {0.0, 1.0};
  static const double q11[] = {1.0};
  static const double q20[] = {-0.5, 0.0, 1.5};
  static const double q21[] = {0.0, 3.0};
  static const double q22[] = {3.0};
  switch (l * 10 + m) {
    case 0: *deg = 0; return q00;
    case 10: *deg = 1; return q10;
    case 11: *deg = 0; return q11;
    case 20: *deg = 2; return q20;
    case 21: *deg = 1; return q21;
    default: *deg = 0; return q22;  // (2, 2)
  }
}

static Poly poly_pow(const Poly& base, int k) {
  Poly out;
  out.c[0][0] = 1.0;
  for (int i = 0; i < k; ++i) out = poly_mul(out, base);
  return out;
}

// (xi +- eta)^(l-m) Q_{l,m}(cos theta) homogenized to a polynomial; on
// center A cos theta = (1+xi eta)/(xi+eta), on B (xi eta-1)/(xi-eta)
static Poly angular_poly(int l, int m, bool side_a) {
  Poly lin, den;
  if (side_a) {
    lin.c[0][0] = 1.0;
    lin.c[1][1] = 1.0;
    den.c[1][0] = 1.0;
    den.c[0][1] = 1.0;
  } else {
    lin.c[0][0] = -1.0;
    lin.c[1][1] = 1.0;
    den.c[1][0] = 1.0;
    den.c[0][1] = -1.0;
  }
  lin.dx = lin.dy = den.dx = den.dy = 1;
  int deg;
  const double* q = assoc_q(l, m, &deg);
  Poly out;
  out.dx = out.dy = 0;
  for (int k = 0; k <= deg; ++k) {
    if (q[k] == 0.0) continue;
    Poly term = poly_mul(poly_pow(lin, k), poly_pow(den, l - m - k));
    const int nx = term.dx > out.dx ? term.dx : out.dx;
    const int ny = term.dy > out.dy ? term.dy : out.dy;
    for (int i = 0; i <= term.dx; ++i)
      for (int j = 0; j <= term.dy; ++j) out.c[i][j] += q[k] * term.c[i][j];
    out.dx = nx;
    out.dy = ny;
  }
  return out;
}

static double ang_norm(int l, int m) {
  return std::sqrt((2 * l + 1) / 2.0 * factorial(l - m) / factorial(l + m));
}

static double sto_overlap(int na, int la, double za, int nb, int lb, double zb,
                          int m, double r) {
  if (m > la || m > lb) return 0.0;
  const double p = 0.5 * r * (za + zb);
  const double q = 0.5 * r * (za - zb);
  Poly xi_plus_eta, xi_minus_eta, pi_factor;
  xi_plus_eta.c[1][0] = 1.0;
  xi_plus_eta.c[0][1] = 1.0;
  xi_plus_eta.dx = xi_plus_eta.dy = 1;
  xi_minus_eta.c[1][0] = 1.0;
  xi_minus_eta.c[0][1] = -1.0;
  xi_minus_eta.dx = xi_minus_eta.dy = 1;
  // (xi^2 - 1)(1 - eta^2)
  pi_factor.c[0][0] = -1.0;
  pi_factor.c[0][2] = 1.0;
  pi_factor.c[2][0] = 1.0;
  pi_factor.c[2][2] = -1.0;
  pi_factor.dx = pi_factor.dy = 2;

  Poly poly = poly_pow(xi_plus_eta, na - la);
  poly = poly_mul(poly, poly_pow(xi_minus_eta, nb - lb));
  poly = poly_mul(poly, angular_poly(la, m, true));
  poly = poly_mul(poly, angular_poly(lb, m, false));
  if (m) poly = poly_mul(poly, poly_pow(pi_factor, m));
  const double ang = ang_norm(la, m) * ang_norm(lb, m);
  const double cnst = sto_norm(na, za) * sto_norm(nb, zb) *
                      std::pow(0.5 * r, na + nb + 1) * ang;
  double av[20], bv[20];
  aux_a(poly.dx, p, av);
  aux_b(poly.dy, q, bv);
  double total = 0.0;
  for (int i = 0; i <= poly.dx; ++i)
    for (int j = 0; j <= poly.dy; ++j)
      if (poly.c[i][j] != 0.0) total += poly.c[i][j] * av[i] * bv[j];
  return cnst * total;
}

// ---------------------------------------------------------------------------
// Dewar-Thiel multipole two-electron integrals
// ---------------------------------------------------------------------------
struct Derived {  // per-element cached quantities (bohr / Hartree)
  double rho[3];  // additive radii for l = 0, 1, 2
  double d1, d2;  // dipole / quadrupole charge separations
};

static double dipole_sep(const Elem& e) {
  const double ns = sto_norm(e.n, e.zs), np = sto_norm(e.n, e.zp);
  return ns * np * factorial(2 * e.n + 1) /
         (std::sqrt(3.0) * std::pow(e.zs + e.zp, 2 * e.n + 2));
}

static double quadrupole_sep(const Elem& e) {
  const double r2 = (2 * e.n + 2) * (2 * e.n + 1) / (4.0 * e.zp * e.zp);
  return std::sqrt(r2 / 5.0);
}

template <typename F>
static double solve_rho(double target, F f) {
  double lo = 1e-3, hi = 60.0;
  if (f(lo) - target < 0.0) return lo;
  for (int i = 0; i < 200; ++i) {
    const double mid = 0.5 * (lo + hi);
    if (f(mid) - target > 0.0)
      lo = mid;
    else
      hi = mid;
  }
  return 0.5 * (lo + hi);
}

static Derived derived_params(const Elem& e) {
  Derived d{};
  const double gss_au = e.gss / kEvPerHartree;
  d.rho[0] = 0.5 / gss_au;
  if (!e.has_p) {
    d.rho[1] = d.rho[2] = d.rho[0];
    d.d1 = d.d2 = 0.0;
    return d;
  }
  d.d1 = dipole_sep(e);
  d.d2 = quadrupole_sep(e);
  const double hsp_au = e.hsp / kEvPerHartree;
  const double hpp_ev = 0.5 * (e.gpp - e.gp2);
  const double hpp_au = (hpp_ev > 0.1 ? hpp_ev : 0.1) / kEvPerHartree;
  const double d1 = d.d1, d2 = d.d2;
  d.rho[1] = solve_rho(hsp_au, [d1](double rho) {
    return 0.25 * (1.0 / rho - 1.0 / std::sqrt(d1 * d1 + rho * rho));
  });
  d.rho[2] = solve_rho(hpp_au, [d2](double rho) {
    return 0.125 / rho - 0.5 / std::sqrt(4.0 * d2 * d2 + 4.0 * rho * rho) +
           0.25 / std::sqrt(8.0 * d2 * d2 + 4.0 * rho * rho);
  });
  return d;
}

// orbital-pair table: (s,px,py,pz) pairs in the order used by nddo_ref.py
static const int kPairIdx[10][2] = {{0, 0}, {0, 1}, {0, 2}, {0, 3}, {1, 1},
                                    {2, 2}, {3, 3}, {1, 2}, {1, 3}, {2, 3}};

struct ChargeCfg {  // one multipole component: up to 4 point charges
  int l;
  int count;
  double q[4];
  double xyz[4][3];
};

// fills cfgs (max 2) for orbital pair `pi`, returns count
static int pair_configs(int pi, double d1, double d2, ChargeCfg* cfgs) {
  const int i = kPairIdx[pi][0], j = kPairIdx[pi][1];
  auto axis = [](int orb) { return orb - 1; };  // px,py,pz -> 0,1,2
  if (i == 0 && j == 0) {
    cfgs[0] = {0, 1, {1.0}, {{0, 0, 0}}};
    return 1;
  }
  if (i == 0) {  // s-p dipole
    ChargeCfg c{1, 2, {0.5, -0.5}, {{0, 0, 0}, {0, 0, 0}}};
    c.xyz[0][axis(j)] = d1;
    c.xyz[1][axis(j)] = -d1;
    cfgs[0] = c;
    return 1;
  }
  if (i == j) {  // monopole + linear quadrupole along the axis
    cfgs[0] = {0, 1, {1.0}, {{0, 0, 0}}};
    ChargeCfg c{2, 3, {0.25, 0.25, -0.5}, {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}}};
    c.xyz[0][axis(i)] = 2.0 * d2;
    c.xyz[1][axis(i)] = -2.0 * d2;
    cfgs[1] = c;
    return 2;
  }
  // p-p' square quadrupole in the (axis_i, axis_j) plane
  ChargeCfg c{2, 4, {0.25, 0.25, -0.25, -0.25},
              {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}}};
  const int ai = axis(i), aj = axis(j);
  c.xyz[0][ai] = d2;
  c.xyz[0][aj] = d2;
  c.xyz[1][ai] = -d2;
  c.xyz[1][aj] = -d2;
  c.xyz[2][ai] = d2;
  c.xyz[2][aj] = -d2;
  c.xyz[3][ai] = -d2;
  c.xyz[3][aj] = d2;
  cfgs[0] = c;
  return 1;
}

// local-frame [10][10] two-center ERIs (Hartree), r in bohr
static void eri_local(const Elem& ea, const Derived& da, const Elem& eb,
                      const Derived& db, double r, double m[10][10]) {
  const int na = ea.has_p ? 10 : 1, nb = eb.has_p ? 10 : 1;
  std::memset(m, 0, sizeof(double) * 100);
  ChargeCfg ca[2], cb[2];
  for (int pa = 0; pa < na; ++pa) {
    const int nca = pair_configs(pa, da.d1, da.d2, ca);
    for (int pb = 0; pb < nb; ++pb) {
      const int ncb = pair_configs(pb, db.d1, db.d2, cb);
      double total = 0.0;
      for (int ia = 0; ia < nca; ++ia)
        for (int ib = 0; ib < ncb; ++ib) {
          const double add = da.rho[ca[ia].l] + db.rho[cb[ib].l];
          const double add2 = add * add;
          for (int u = 0; u < ca[ia].count; ++u)
            for (int v = 0; v < cb[ib].count; ++v) {
              const double dx = ca[ia].xyz[u][0] - cb[ib].xyz[v][0];
              const double dy = ca[ia].xyz[u][1] - cb[ib].xyz[v][1];
              const double dz = ca[ia].xyz[u][2] - (cb[ib].xyz[v][2] + r);
              total += ca[ia].q[u] * cb[ib].q[v] /
                       std::sqrt(dx * dx + dy * dy + dz * dz + add2);
            }
        }
      m[pa][pb] = total;
    }
  }
}

// [10][10] pair matrix -> [4][4][4][4] tensor with pair symmetry, then rotate
static void rotate_eri(const double m[10][10], const double w[4][4],
                       double out[4][4][4][4]) {
  double t[4][4][4][4];
  std::memset(t, 0, sizeof(t));
  for (int pa = 0; pa < 10; ++pa) {
    const int i = kPairIdx[pa][0], j = kPairIdx[pa][1];
    for (int pb = 0; pb < 10; ++pb) {
      const int k = kPairIdx[pb][0], l = kPairIdx[pb][1];
      const double v = m[pa][pb];
      t[i][j][k][l] = t[j][i][k][l] = t[i][j][l][k] = t[j][i][l][k] = v;
    }
  }
  // contract one index at a time: O(4^5) per stage
  double tmp1[4][4][4][4], tmp2[4][4][4][4];
  std::memset(tmp1, 0, sizeof(tmp1));
  for (int a = 0; a < 4; ++a)
    for (int mm = 0; mm < 4; ++mm) {
      if (w[a][mm] == 0.0) continue;
      for (int b = 0; b < 4; ++b)
        for (int c = 0; c < 4; ++c)
          for (int d = 0; d < 4; ++d)
            tmp1[a][b][c][d] += w[a][mm] * t[mm][b][c][d];
    }
  std::memset(tmp2, 0, sizeof(tmp2));
  for (int b = 0; b < 4; ++b)
    for (int mm = 0; mm < 4; ++mm) {
      if (w[b][mm] == 0.0) continue;
      for (int a = 0; a < 4; ++a)
        for (int c = 0; c < 4; ++c)
          for (int d = 0; d < 4; ++d)
            tmp2[a][b][c][d] += w[b][mm] * tmp1[a][mm][c][d];
    }
  std::memset(tmp1, 0, sizeof(tmp1));
  for (int c = 0; c < 4; ++c)
    for (int mm = 0; mm < 4; ++mm) {
      if (w[c][mm] == 0.0) continue;
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b)
          for (int d = 0; d < 4; ++d)
            tmp1[a][b][c][d] += w[c][mm] * tmp2[a][b][mm][d];
    }
  std::memset(out, 0, sizeof(double) * 256);
  for (int d = 0; d < 4; ++d)
    for (int mm = 0; mm < 4; ++mm) {
      if (w[d][mm] == 0.0) continue;
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b)
          for (int c = 0; c < 4; ++c)
            out[a][b][c][d] += w[d][mm] * tmp1[a][b][c][mm];
    }
}

// local frame: columns x', y', z' with z' along rvec (matches nddo_ref.py)
static void local_frame(const double rvec[3], double u[3][3]) {
  const double nrm =
      std::sqrt(rvec[0] * rvec[0] + rvec[1] * rvec[1] + rvec[2] * rvec[2]);
  double z[3] = {rvec[0] / nrm, rvec[1] / nrm, rvec[2] / nrm};
  double seed[3] = {1.0, 0.0, 0.0};
  if (std::fabs(z[0]) > 0.9) {
    seed[0] = 0.0;
    seed[1] = 1.0;
  }
  const double dot = seed[0] * z[0] + seed[1] * z[1] + seed[2] * z[2];
  double x[3] = {seed[0] - dot * z[0], seed[1] - dot * z[1],
                 seed[2] - dot * z[2]};
  const double xn = std::sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
  for (int i = 0; i < 3; ++i) x[i] /= xn;
  const double y[3] = {z[1] * x[2] - z[2] * x[1], z[2] * x[0] - z[0] * x[2],
                       z[0] * x[1] - z[1] * x[0]};
  for (int i = 0; i < 3; ++i) {
    u[i][0] = x[i];
    u[i][1] = y[i];
    u[i][2] = z[i];
  }
}

// ---------------------------------------------------------------------------
// d-shell machinery (MNDO/d formalism) — C++ port of the derived-from-first-
// principles oracle in calculators/nddo_ref.py: real-Gaunt coefficients by
// exact quadrature, Slater-Condon radial integrals in closed form, point-
// multipole configs by moment matching, Klopman radii from one-center
// limits. Orbital order: s, px, py, pz, dz2, dxz, dyz, dx2-y2, dxy.
// ---------------------------------------------------------------------------

static const int kOrbL[9] = {0, 1, 1, 1, 2, 2, 2, 2, 2};
static const int kOrbT[9] = {0, 1, 2, 0, 0, 1, 2, 3, 4};

// Gauss-Legendre nodes/weights on [-1, 1] by Newton iteration
static void gauss_legendre(int n, double* x, double* w) {
  for (int i = 0; i < n; ++i) {
    double t = std::cos(M_PI * (i + 0.75) / (n + 0.5));
    for (int it = 0; it < 100; ++it) {
      double p0 = 1.0, p1 = t;
      for (int k = 2; k <= n; ++k) {
        const double p2 = ((2 * k - 1) * t * p1 - (k - 1) * p0) / k;
        p0 = p1;
        p1 = p2;
      }
      const double dp = n * (t * p1 - p0) / (t * t - 1.0);
      const double dt = p1 / dp;
      t -= dt;
      if (std::fabs(dt) < 1e-15) break;
    }
    double p0 = 1.0, p1 = t;
    for (int k = 2; k <= n; ++k) {
      const double p2 = ((2 * k - 1) * t * p1 - (k - 1) * p0) / k;
      p0 = p1;
      p1 = p2;
    }
    const double dp = n * (t * p1 - p0) / (t * t - 1.0);
    x[i] = t;
    w[i] = 2.0 / ((1.0 - t * t) * dp * dp);
  }
}

// associated Legendre P_l^m without the Condon-Shortley phase
static double legendre_pm(int l, int m, double x) {
  double pmm = 1.0;
  if (m > 0) {
    double fact = 1.0;
    for (int i = 1; i < 2 * m; i += 2) fact *= i;
    pmm = std::pow(std::sqrt(std::max(0.0, 1.0 - x * x)), m) * fact;
  }
  if (l == m) return pmm;
  double pm1 = x * (2 * m + 1) * pmm;
  if (l == m + 1) return pm1;
  for (int ll = m + 2; ll <= l; ++ll) {
    const double p = ((2 * ll - 1) * x * pm1 - (ll + m - 1) * pmm) / (ll - m);
    pmm = pm1;
    pm1 = p;
  }
  return pm1;
}

// real spherical harmonic S_{l,t}: t = 0 -> m = 0; odd t = 2m-1 -> cos m phi;
// even t = 2m -> sin m phi
static double real_sph(int l, int t, const double xyz[3]) {
  const int m = (t + 1) / 2;
  const double ct = std::max(-1.0, std::min(1.0, xyz[2]));
  const double norm =
      std::sqrt((2 * l + 1) / (4.0 * M_PI) * factorial(l - m) /
                factorial(l + m) * (m ? 2.0 : 1.0));
  const double plm = legendre_pm(l, m, ct);
  if (m == 0) return norm * plm;
  const double phi = std::atan2(xyz[1], xyz[0]);
  return norm * plm * (t % 2 == 1 ? std::cos(m * phi) : std::sin(m * phi));
}

// real Gaunt coefficients int S_{l1,t1} S_{l2,t2} S_{lo,to} dOmega over the
// 9-orbital basis x L <= 4, precomputed once (exact 24 x 48 product grid)
struct GauntTable {
  // [mu][nu][lo][to]
  double g[9][9][5][9];
  GauntTable() {
    constexpr int kNt = 24, kNp = 48;
    double xs[kNt], ws[kNt];
    gauss_legendre(kNt, xs, ws);
    std::memset(g, 0, sizeof(g));
    for (int it = 0; it < kNt; ++it) {
      const double ct = xs[it], st = std::sqrt(1.0 - ct * ct);
      for (int ip = 0; ip < kNp; ++ip) {
        const double phi = (ip + 0.5) * (2.0 * M_PI / kNp);
        const double xyz[3] = {st * std::cos(phi), st * std::sin(phi), ct};
        const double wq = ws[it] * (2.0 * M_PI / kNp);
        double sv[9], so[5][9];
        for (int mu = 0; mu < 9; ++mu)
          sv[mu] = real_sph(kOrbL[mu], kOrbT[mu], xyz);
        for (int lo = 0; lo <= 4; ++lo)
          for (int to = 0; to < 2 * lo + 1; ++to)
            so[lo][to] = real_sph(lo, to, xyz);
        for (int mu = 0; mu < 9; ++mu)
          for (int nu = 0; nu < 9; ++nu)
            for (int lo = 0; lo <= 4; ++lo)
              for (int to = 0; to < 2 * lo + 1; ++to)
                g[mu][nu][lo][to] += wq * sv[mu] * sv[nu] * so[lo][to];
      }
    }
    for (auto& a : g)
      for (auto& b : a)
        for (auto& c : b)
          for (double& v : c)
            if (std::fabs(v) < 1e-12) v = 0.0;
  }
};

static const GauntTable& gaunt_table() {
  static const GauntTable t;
  return t;
}

static double radial_moment(int n1, double z1, int n2, double z2, int lq) {
  return sto_norm(n1, z1) * sto_norm(n2, z2) * factorial(n1 + n2 + lq) /
         std::pow(z1 + z2, n1 + n2 + lq + 1);
}

// Slater-Condon R^k(ab; cd): electron 1 carries (a, c), electron 2 (b, d)
static double slater_rk(int k, int na, double za, int nb, double zb, int nc,
                        double zc, int nd, double zd) {
  const int p1 = na + nc, p2 = nb + nd;
  const double alpha = za + zc, beta = zb + zd;
  const double norm =
      sto_norm(na, za) * sto_norm(nb, zb) * sto_norm(nc, zc) * sto_norm(nd, zd);
  auto a_int = [](int m, double gg) {
    return factorial(m) / std::pow(gg, m + 1);
  };
  const int m1 = p2 + k, m2 = p2 - k - 1;
  double total = a_int(m1, beta) * a_int(p1 - k - 1, alpha);
  for (int j = 0; j <= m1; ++j)
    total -= a_int(m1, beta) * std::pow(beta, j) / factorial(j) *
             a_int(p1 - k - 1 + j, alpha + beta);
  for (int j = 0; j <= m2; ++j)
    total += a_int(m2, beta) * std::pow(beta, j) / factorial(j) *
             a_int(p1 + k + j, alpha + beta);
  return norm * total;
}

// R^k with electron-1 shells (s1a, s1b) and electron-2 shells (s2a, s2b)
// (0 = s, 1 = p, 2 = d). Honors the PM6 internal exponent set and the
// f0sd/g2sd Slater-Condon overrides exactly like nddo_ref.py
// _one_center_rk (falls back to basis exponents when unparameterized).
static double one_center_rk(const Elem& e, int k, int s1a, int s1b, int s2a,
                            int s2b) {
  const int a1 = s1a < s1b ? s1a : s1b, b1 = s1a < s1b ? s1b : s1a;
  const int a2 = s2a < s2b ? s2a : s2b, b2 = s2a < s2b ? s2b : s2a;
  if (k == 0 && e.f0sd > 0.0 &&
      ((a1 == 0 && b1 == 0 && a2 == 2 && b2 == 2) ||
       (a1 == 2 && b1 == 2 && a2 == 0 && b2 == 0)))
    return e.f0sd / kEvPerHartree;
  if (k == 2 && e.g2sd > 0.0 && a1 == 0 && b1 == 2 && a2 == 0 && b2 == 2)
    return e.g2sd / kEvPerHartree;
  const double zz[3] = {e.zsn > 0.0 ? e.zsn : e.zs,
                        e.zpn > 0.0 ? e.zpn : e.zp,
                        e.zdn > 0.0 ? e.zdn : e.zd};
  return slater_rk(k, e.n, zz[s1a], e.n, zz[s2a], e.n, zz[s1b], e.n, zz[s2b]);
}

// one-center [9][9][9][9] ERI tensor: parameterized sp block + Gaunt-built
// analytic d-involving entries
static void one_center_eri_spd(const Elem& e, double* t9) {
  const GauntTable& gt = gaunt_table();
  std::memset(t9, 0, sizeof(double) * 6561);
  auto at = [&](int a, int b, int c, int d) -> double& {
    return t9[((a * 9 + b) * 9 + c) * 9 + d];
  };
  for (int mu = 0; mu < 9; ++mu)
    for (int nu = mu; nu < 9; ++nu)
      for (int la = 0; la < 9; ++la)
        for (int sg = la; sg < 9; ++sg) {
          const int lmx = std::max(std::max(kOrbL[mu], kOrbL[nu]),
                                   std::max(kOrbL[la], kOrbL[sg]));
          if (lmx < 2) continue;  // sp block parameterized below
          double val = 0.0;
          for (int lo = 0; lo <= 4; ++lo) {
            double rk = 0.0;
            bool have_rk = false;
            for (int to = 0; to < 2 * lo + 1; ++to) {
              const double g1 = gt.g[mu][nu][lo][to];
              if (g1 == 0.0) continue;
              const double g2 = gt.g[la][sg][lo][to];
              if (g2 == 0.0) continue;
              if (!have_rk) {
                rk = one_center_rk(e, lo, kOrbL[mu], kOrbL[nu], kOrbL[la],
                                   kOrbL[sg]);
                have_rk = true;
              }
              val += 4.0 * M_PI / (2 * lo + 1) * rk * g1 * g2;
            }
          }
          if (val != 0.0) {
            at(mu, nu, la, sg) = at(nu, mu, la, sg) = val;
            at(mu, nu, sg, la) = at(nu, mu, sg, la) = val;
          }
        }
  const double g = 1.0 / kEvPerHartree;
  at(0, 0, 0, 0) = e.gss * g;
  const double hpp = 0.5 * (e.gpp - e.gp2);
  for (int i = 1; i < 4; ++i) {
    at(0, 0, i, i) = at(i, i, 0, 0) = e.gsp * g;
    at(i, i, i, i) = e.gpp * g;
    at(0, i, 0, i) = at(i, 0, 0, i) = e.hsp * g;
    at(0, i, i, 0) = at(i, 0, i, 0) = e.hsp * g;
    for (int j = 1; j < 4; ++j)
      if (i != j) {
        at(i, i, j, j) = e.gp2 * g;
        at(i, j, i, j) = at(i, j, j, i) = hpp * g;
      }
  }
}

// point-charge geometry per multipole component (L, t) at separation d
struct ChargePt {
  double q;
  double xyz[3];
};

static int config_charges(int lo, int to, double d, ChargePt* out) {
  auto set = [](ChargePt& c, double q, double x, double y, double z) {
    c.q = q;
    c.xyz[0] = x;
    c.xyz[1] = y;
    c.xyz[2] = z;
  };
  if (lo == 0) {
    set(out[0], 1.0, 0, 0, 0);
    return 1;
  }
  if (lo == 1) {
    double e[3] = {0, 0, 0};
    e[to == 0 ? 2 : (to == 1 ? 0 : 1)] = 1.0;
    set(out[0], 0.5, d * e[0], d * e[1], d * e[2]);
    set(out[1], -0.5, -d * e[0], -d * e[1], -d * e[2]);
    return 2;
  }
  if (to == 0) {  // linear quadrupole along z
    set(out[0], 0.25, 0, 0, 2 * d);
    set(out[1], 0.25, 0, 0, -2 * d);
    set(out[2], -0.5, 0, 0, 0);
    return 3;
  }
  if (to == 1 || to == 2) {  // square in the (x,z) / (y,z) plane
    const double ex = to == 1 ? d : 0.0, ey = to == 1 ? 0.0 : d;
    set(out[0], 0.25, ex, ey, d);
    set(out[1], -0.25, ex, ey, -d);
    set(out[2], -0.25, -ex, -ey, d);
    set(out[3], 0.25, -ex, -ey, -d);
    return 4;
  }
  if (to == 3) {  // x^2 - y^2
    const double s = std::sqrt(2.0) * d;
    set(out[0], 0.25, s, 0, 0);
    set(out[1], 0.25, -s, 0, 0);
    set(out[2], -0.25, 0, s, 0);
    set(out[3], -0.25, 0, -s, 0);
    return 4;
  }
  // to == 4: xy square
  set(out[0], 0.25, d, d, 0);
  set(out[1], 0.25, -d, -d, 0);
  set(out[2], -0.25, d, -d, 0);
  set(out[3], -0.25, -d, d, 0);
  return 4;
}

static double config_moment_unit(int lo, int to) {
  ChargePt c[4];
  const int n = config_charges(lo, to, 1.0, c);
  double total = 0.0;
  for (int i = 0; i < n; ++i) {
    const double rn = std::sqrt(c[i].xyz[0] * c[i].xyz[0] +
                                c[i].xyz[1] * c[i].xyz[1] +
                                c[i].xyz[2] * c[i].xyz[2]);
    if (rn < 1e-15) continue;
    const double unit[3] = {c[i].xyz[0] / rn, c[i].xyz[1] / rn,
                            c[i].xyz[2] / rn};
    total += c[i].q * std::pow(rn, lo) *
             std::sqrt(4.0 * M_PI / (2 * lo + 1)) * real_sph(lo, to, unit);
  }
  return total;
}

static double kernel_self_interaction(int lo, int to, double d, double rho) {
  ChargePt c[4];
  const int n = config_charges(lo, to, d, c);
  double total = 0.0;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      const double dx = c[i].xyz[0] - c[j].xyz[0];
      const double dy = c[i].xyz[1] - c[j].xyz[1];
      const double dz = c[i].xyz[2] - c[j].xyz[2];
      total += c[i].q * c[j].q /
               std::sqrt(dx * dx + dy * dy + dz * dz + 4.0 * rho * rho);
    }
  return total;
}

// one multipole component of a local-frame orbital-pair distribution
struct PairComponent {
  int l;
  double rho;
  int n_charges;
  ChargePt charges[8];
};

struct SpdPairTable {  // per-element: components for every (mu <= nu) pair
  int n_comp[45];
  PairComponent comp[45][3];
};

static int pair_index9(int mu, int nu) {  // mu <= nu upper-triangle index
  return mu * 9 - mu * (mu + 1) / 2 + nu;
}

// canonical orbital pair per d-involving (shell_a, shell_b, L)
struct CanonKey {
  int sa, sb, lo, mu, nu;
};
static const CanonKey kCanon[] = {
    {0, 2, 2, 0, 4}, {1, 2, 1, 3, 4}, {2, 2, 2, 4, 4}};

static void build_pair_table(const Elem& e, SpdPairTable* table) {
  const GauntTable& gt = gaunt_table();
  const Derived der = derived_params(e);
  const double zeta[3] = {e.zs, e.zp, e.zd};
  const int size = n_orbs(e);
  // D separations and Klopman radii per (shell pair, L)
  double dsep[3][3][3] = {};
  double rho[3][3][3] = {};
  rho[0][0][0] = der.rho[0];
  rho[1][1][0] = der.rho[0];
  rho[0][1][1] = der.rho[1];
  rho[1][1][2] = der.rho[2];
  dsep[0][1][1] = dipole_sep(e);
  dsep[1][1][2] = quadrupole_sep(e);
  for (const CanonKey& ck : kCanon) {
    const int lm = kOrbL[ck.mu];
    const int ln = kOrbL[ck.nu];
    int to_c = -1;
    double gq = 0.0;
    for (int to = 0; to < 2 * ck.lo + 1; ++to)
      if (gt.g[ck.mu][ck.nu][ck.lo][to] != 0.0) {
        to_c = to;
        gq = gt.g[ck.mu][ck.nu][ck.lo][to];
        break;
      }
    const double moment =
        radial_moment(e.n, zeta[ck.sa], e.n, zeta[ck.sb], ck.lo) *
        std::sqrt(4.0 * M_PI / (2 * ck.lo + 1)) * gq;
    const double d = std::pow(
        std::fabs(moment) / std::fabs(config_moment_unit(ck.lo, to_c)),
        1.0 / ck.lo);
    dsep[ck.sa][ck.sb][ck.lo] = d;
    const double target = 4.0 * M_PI / (2 * ck.lo + 1) *
                          one_center_rk(e, ck.lo, lm, ln, lm, ln) * gq * gq;
    rho[ck.sa][ck.sb][ck.lo] = solve_rho(target, [&](double r) {
      return kernel_self_interaction(ck.lo, to_c, d, r);
    });
  }
  if (e.has_d) rho[2][2][0] = 0.5 / one_center_rk(e, 0, 2, 2, 2, 2);
  // classic sp configs for the sp block; component scheme for d pairs
  for (int m = 0; m < size; ++m)
    for (int nn = m; nn < size; ++nn) {
      const int pi = pair_index9(m, nn);
      table->n_comp[pi] = 0;
      if (m < 4 && nn < 4) {
        // map to the classic _PAIRS order configs
        int pair_pi = -1;
        for (int p = 0; p < 10; ++p)
          if ((kPairIdx[p][0] == m && kPairIdx[p][1] == nn) ||
              (kPairIdx[p][0] == nn && kPairIdx[p][1] == m))
            pair_pi = p;
        ChargeCfg cfgs[2];
        const int nc = pair_configs(pair_pi, der.d1, der.d2, cfgs);
        for (int ic = 0; ic < nc; ++ic) {
          PairComponent& pc = table->comp[pi][table->n_comp[pi]++];
          pc.l = cfgs[ic].l;
          pc.rho = der.rho[cfgs[ic].l];
          pc.n_charges = cfgs[ic].count;
          for (int u = 0; u < cfgs[ic].count; ++u) {
            pc.charges[u].q = cfgs[ic].q[u];
            for (int x = 0; x < 3; ++x)
              pc.charges[u].xyz[x] = cfgs[ic].xyz[u][x];
          }
        }
        continue;
      }
      const int lm = kOrbL[m];
      const int ln = kOrbL[nn];
      int sa = lm, sb = ln;  // shell index == angular momentum (s, p, d)
      if (sa > sb) std::swap(sa, sb);
      for (int lo = 0; lo <= 2; ++lo) {
        PairComponent pc;
        pc.l = lo;
        pc.rho = rho[sa][sb][lo];
        pc.n_charges = 0;
        for (int to = 0; to < 2 * lo + 1; ++to) {
          const double gq = gt.g[m][nn][lo][to];
          if (gq == 0.0) continue;
          if (lo == 0) {
            if (m == nn) {
              pc.charges[pc.n_charges].q = 1.0;
              std::memset(pc.charges[pc.n_charges].xyz, 0, sizeof(double) * 3);
              ++pc.n_charges;
            }
            continue;
          }
          const double dref = dsep[sa][sb][lo];
          const double moment =
              radial_moment(e.n, zeta[sa], e.n, zeta[sb], lo) *
              std::sqrt(4.0 * M_PI / (2 * lo + 1)) * gq;
          const double scale =
              moment / (config_moment_unit(lo, to) * std::pow(dref, lo));
          ChargePt cc[4];
          const int ncc = config_charges(lo, to, dref, cc);
          for (int u = 0; u < ncc; ++u) {
            if (cc[u].q * scale == 0.0) continue;
            pc.charges[pc.n_charges] = cc[u];
            pc.charges[pc.n_charges].q *= scale;
            ++pc.n_charges;
          }
        }
        if (pc.n_charges) table->comp[pi][table->n_comp[pi]++] = pc;
      }
    }
}

// cached per-element pair tables (thread-safe one-time init)
static const SpdPairTable* spd_pair_table(const Elem& e) {
  constexpr int kMax = sizeof(kElems) / sizeof(kElems[0]);
  static SpdPairTable tables[kMax];
  static std::once_flag flags[kMax];
  int idx = -1;
  for (int i = 0; i < kMax; ++i)
    if (kElems[i].z == e.z) idx = i;
  std::call_once(flags[idx], [&] { build_pair_table(e, &tables[idx]); });
  return &tables[idx];
}

// exact 5x5 real-d rotation from the quadratic-form representation
static void d_rotation(const double u[3][3], double d5[5][5]) {
  const double s2 = std::sqrt(2.0), s6 = std::sqrt(6.0);
  double forms[5][3][3] = {};
  forms[0][0][0] = -1.0 / s6;
  forms[0][1][1] = -1.0 / s6;
  forms[0][2][2] = 2.0 / s6;
  forms[1][0][2] = forms[1][2][0] = 1.0 / s2;
  forms[2][1][2] = forms[2][2][1] = 1.0 / s2;
  forms[3][0][0] = 1.0 / s2;
  forms[3][1][1] = -1.0 / s2;
  forms[4][0][1] = forms[4][1][0] = 1.0 / s2;
  for (int j = 0; j < 5; ++j) {
    double rot[3][3] = {};
    for (int a = 0; a < 3; ++a)
      for (int d = 0; d < 3; ++d) {
        double acc = 0.0;
        for (int b = 0; b < 3; ++b)
          for (int c = 0; c < 3; ++c)
            acc += u[a][b] * forms[j][b][c] * u[d][c];
        rot[a][d] = acc;
      }
    for (int i = 0; i < 5; ++i) {
      double acc = 0.0;
      for (int a = 0; a < 3; ++a)
        for (int d = 0; d < 3; ++d) acc += forms[i][a][d] * rot[a][d];
      d5[i][j] = acc;
    }
  }
}

// size x size orbital rotation: 1 (+) u (+) d_rotation(u)
static void orbital_rotation(const double u[3][3], int size, double w[9][9]) {
  std::memset(w, 0, sizeof(double) * 81);
  w[0][0] = 1.0;
  if (size > 1)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) w[1 + i][1 + j] = u[i][j];
  if (size > 4) {
    double d5[5][5];
    d_rotation(u, d5);
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 5; ++j) w[4 + i][4 + j] = d5[i][j];
  }
}

// generic local-frame two-center ERI tensor [sa, sa, sb, sb] (row-major)
// for pairs where at least one atom carries a d shell
static void two_center_eri_generic(const Elem& ea, const Elem& eb, double r,
                                   std::vector<double>& out) {
  const int sa = n_orbs(ea), sb = n_orbs(eb);
  const SpdPairTable* ta = spd_pair_table(ea);
  const SpdPairTable* tb = spd_pair_table(eb);
  out.assign(size_t(sa) * sa * sb * sb, 0.0);
  auto at = [&](int i, int j, int k, int l) -> double& {
    return out[((size_t(i) * sa + j) * sb + k) * sb + l];
  };
  for (int i = 0; i < sa; ++i)
    for (int j = i; j < sa; ++j) {
      const int pi = pair_index9(i, j);
      if (!ta->n_comp[pi]) continue;
      for (int k = 0; k < sb; ++k)
        for (int l = k; l < sb; ++l) {
          const int pj = pair_index9(k, l);
          if (!tb->n_comp[pj]) continue;
          double total = 0.0;
          for (int ca = 0; ca < ta->n_comp[pi]; ++ca) {
            const PairComponent& pca = ta->comp[pi][ca];
            for (int cb = 0; cb < tb->n_comp[pj]; ++cb) {
              const PairComponent& pcb = tb->comp[pj][cb];
              const double add2 =
                  (pca.rho + pcb.rho) * (pca.rho + pcb.rho);
              for (int u = 0; u < pca.n_charges; ++u)
                for (int v = 0; v < pcb.n_charges; ++v) {
                  const double dx =
                      pca.charges[u].xyz[0] - pcb.charges[v].xyz[0];
                  const double dy =
                      pca.charges[u].xyz[1] - pcb.charges[v].xyz[1];
                  const double dz =
                      pca.charges[u].xyz[2] - (pcb.charges[v].xyz[2] + r);
                  total += pca.charges[u].q * pcb.charges[v].q /
                           std::sqrt(dx * dx + dy * dy + dz * dz + add2);
                }
            }
          }
          at(i, j, k, l) = at(j, i, k, l) = total;
          at(i, j, l, k) = at(j, i, l, k) = total;
        }
    }
}

// rotate a [sa, sa, sb, sb] local tensor to the global frame with per-atom
// orbital rotations wa, wb (one index at a time)
static void rotate_eri_generic(std::vector<double>& t, int sa, int sb,
                               const double wa[9][9], const double wb[9][9]) {
  std::vector<double> tmp(t.size());
  const size_t n2 = size_t(sa) * sb * sb;   // stride of first index
  const size_t n3 = size_t(sb) * sb;        // stride of second index
  // index 0
  std::fill(tmp.begin(), tmp.end(), 0.0);
  for (int a = 0; a < sa; ++a)
    for (int m = 0; m < sa; ++m) {
      const double wv = wa[a][m];
      if (wv == 0.0) continue;
      for (size_t rest = 0; rest < n2; ++rest)
        tmp[a * n2 + rest] += wv * t[m * n2 + rest];
    }
  t.swap(tmp);
  // index 1
  std::fill(tmp.begin(), tmp.end(), 0.0);
  for (int a = 0; a < sa; ++a)
    for (int b = 0; b < sa; ++b)
      for (int m = 0; m < sa; ++m) {
        const double wv = wa[b][m];
        if (wv == 0.0) continue;
        for (size_t rest = 0; rest < n3; ++rest)
          tmp[a * n2 + b * n3 + rest] += wv * t[a * n2 + m * n3 + rest];
      }
  t.swap(tmp);
  // index 2
  std::fill(tmp.begin(), tmp.end(), 0.0);
  for (size_t ab = 0; ab < size_t(sa) * sa; ++ab)
    for (int c = 0; c < sb; ++c)
      for (int m = 0; m < sb; ++m) {
        const double wv = wb[c][m];
        if (wv == 0.0) continue;
        for (int d = 0; d < sb; ++d)
          tmp[ab * n3 + c * sb + d] += wv * t[ab * n3 + m * sb + d];
      }
  t.swap(tmp);
  // index 3
  std::fill(tmp.begin(), tmp.end(), 0.0);
  for (size_t abc = 0; abc < size_t(sa) * sa * sb; ++abc)
    for (int d = 0; d < sb; ++d)
      for (int m = 0; m < sb; ++m)
        tmp[abc * sb + d] += wb[d][m] * t[abc * sb + m];
  t.swap(tmp);
}

// ---------------------------------------------------------------------------
// Symmetric eigensolver: Householder tridiagonalization + implicit QL
// ---------------------------------------------------------------------------
static void tred2(std::vector<double>& a, int n, std::vector<double>& d,
                  std::vector<double>& e) {
  for (int i = n - 1; i >= 1; --i) {
    const int l = i - 1;
    double h = 0.0, scale = 0.0;
    if (l > 0) {
      for (int k = 0; k <= l; ++k) scale += std::fabs(a[i * n + k]);
      if (scale == 0.0) {
        e[i] = a[i * n + l];
      } else {
        for (int k = 0; k <= l; ++k) {
          a[i * n + k] /= scale;
          h += a[i * n + k] * a[i * n + k];
        }
        double f = a[i * n + l];
        double g = f >= 0.0 ? -std::sqrt(h) : std::sqrt(h);
        e[i] = scale * g;
        h -= f * g;
        a[i * n + l] = f - g;
        f = 0.0;
        for (int j = 0; j <= l; ++j) {
          a[j * n + i] = a[i * n + j] / h;
          g = 0.0;
          for (int k = 0; k <= j; ++k) g += a[j * n + k] * a[i * n + k];
          for (int k = j + 1; k <= l; ++k) g += a[k * n + j] * a[i * n + k];
          e[j] = g / h;
          f += e[j] * a[i * n + j];
        }
        const double hh = f / (h + h);
        for (int j = 0; j <= l; ++j) {
          f = a[i * n + j];
          e[j] = g = e[j] - hh * f;
          for (int k = 0; k <= j; ++k)
            a[j * n + k] -= f * e[k] + g * a[i * n + k];
        }
      }
    } else {
      e[i] = a[i * n + l];
    }
    d[i] = h;
  }
  d[0] = 0.0;
  e[0] = 0.0;
  for (int i = 0; i < n; ++i) {
    const int l = i - 1;
    if (d[i] != 0.0) {
      for (int j = 0; j <= l; ++j) {
        double g = 0.0;
        for (int k = 0; k <= l; ++k) g += a[i * n + k] * a[k * n + j];
        for (int k = 0; k <= l; ++k) a[k * n + j] -= g * a[k * n + i];
      }
    }
    d[i] = a[i * n + i];
    a[i * n + i] = 1.0;
    for (int j = 0; j <= l; ++j) a[j * n + i] = a[i * n + j] = 0.0;
  }
}

static double pythag(double a, double b) {
  const double aa = std::fabs(a), ab = std::fabs(b);
  if (aa > ab) {
    const double r = ab / aa;
    return aa * std::sqrt(1.0 + r * r);
  }
  if (ab == 0.0) return 0.0;
  const double r = aa / ab;
  return ab * std::sqrt(1.0 + r * r);
}

static void tqli(std::vector<double>& d, std::vector<double>& e, int n,
                 std::vector<double>& z) {
  for (int i = 1; i < n; ++i) e[i - 1] = e[i];
  e[n - 1] = 0.0;
  for (int l = 0; l < n; ++l) {
    int iter = 0;
    int m;
    do {
      for (m = l; m < n - 1; ++m) {
        const double dd = std::fabs(d[m]) + std::fabs(d[m + 1]);
        if (std::fabs(e[m]) <= 1e-300 + 2.3e-16 * dd) break;
      }
      if (m != l) {
        if (iter++ == 50) return;  // give up; SCF will report non-convergence
        double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
        double r = pythag(g, 1.0);
        g = d[m] - d[l] + e[l] / (g + (g >= 0.0 ? std::fabs(r) : -std::fabs(r)));
        double s = 1.0, c = 1.0, p = 0.0;
        for (int i = m - 1; i >= l; --i) {
          double f = s * e[i], b = c * e[i];
          r = pythag(f, g);
          e[i + 1] = r;
          if (r == 0.0) {
            d[i + 1] -= p;
            e[m] = 0.0;
            break;
          }
          s = f / r;
          c = g / r;
          g = d[i + 1] - p;
          r = (d[i] - g) * s + 2.0 * c * b;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - b;
          for (int k = 0; k < n; ++k) {
            f = z[k * n + i + 1];
            z[k * n + i + 1] = s * z[k * n + i] + c * f;
            z[k * n + i] = c * z[k * n + i] - s * f;
          }
        }
        if (r == 0.0 && m - 1 >= l) continue;
        d[l] -= p;
        e[l] = g;
        e[m] = 0.0;
      }
    } while (m != l);
  }
}

// eigendecomposition of symmetric f[n*n]; eigvals ascending into w, vectors
// into columns of v
static void eigh(const double* f, int n, std::vector<double>& w,
                 std::vector<double>& v) {
  v.assign(f, f + n * n);
  w.assign(n, 0.0);
  std::vector<double> e(n, 0.0);
  tred2(v, n, w, e);
  tqli(w, e, n, v);
  // sort ascending (tqli output is unsorted)
  for (int i = 0; i < n - 1; ++i) {
    int k = i;
    for (int j = i + 1; j < n; ++j)
      if (w[j] < w[k]) k = j;
    if (k != i) {
      std::swap(w[i], w[k]);
      for (int r = 0; r < n; ++r) std::swap(v[r * n + i], v[r * n + k]);
    }
  }
}

// ---------------------------------------------------------------------------
// Molecule assembly + UHF SCF
// ---------------------------------------------------------------------------
struct Molecule {
  int n_atoms = 0;
  int n_orb = 0;
  int n_alpha = 0, n_beta = 0;
  std::vector<const Elem*> el;
  std::vector<int> offset, size;
  std::vector<double> hcore;                 // [n_orb * n_orb]
  // per pair (a<b): exact-dim [sa, sa, sb, sb] row-major tensor
  std::vector<std::vector<double>> eri2c;
  std::vector<std::pair<int, int>> pairs;    // (a, b) with a < b
  // per atom: exact-dim [s, s, s, s] row-major tensor
  std::vector<std::vector<double>> eri1c;
  double e_nuc = 0.0;
  bool ok = false;
};

static double core_core(const Elem& a, const Elem& b, double r_bohr,
                        double gamma_ss) {
  const double r = r_bohr * kAngstromPerBohr;
  double alpha, x;
  bool gauss_r2;
  pair_cc(a.z, b.z, &alpha, &x, &gauss_r2);
  const double f = gauss_r2 ? 1.0 + x * std::exp(-alpha * r * r)
                            : 1.0 + x * std::exp(-alpha *
                                                 (r + 0.0003 * std::pow(r, 6)));
  double e = a.zval * b.zval * gamma_ss * f;
  e += 1e-8 *
       std::pow((std::cbrt(double(a.z)) + std::cbrt(double(b.z))) / r, 12) /
       kEvPerHartree;
  if (a.z == 6 && b.z == 6) e += 9.28 * std::exp(-5.98 * r) / kEvPerHartree;
  return e;
}

static bool build(Molecule& mol, const int* zs, const double* pos_ang, int n,
                  int charge, int multiplicity) {
  mol.n_atoms = n;
  mol.el.resize(n);
  mol.offset.resize(n);
  mol.size.resize(n);
  int off = 0;
  double zval_sum = 0.0;
  int zsum = 0;
  for (int i = 0; i < n; ++i) {
    mol.el[i] = elem(zs[i]);
    if (!mol.el[i]) return false;
    mol.offset[i] = off;
    mol.size[i] = n_orbs(*mol.el[i]);
    off += mol.size[i];
    zval_sum += mol.el[i]->zval;
    zsum += zs[i];
  }
  mol.n_orb = off;
  if (multiplicity <= 0) multiplicity = zsum % 2 + 1;
  const int nelec = int(zval_sum) - charge;
  mol.n_alpha = (nelec + multiplicity - 1) / 2;
  mol.n_beta = nelec - mol.n_alpha;
  if (mol.n_alpha - mol.n_beta != multiplicity - 1 || mol.n_beta < 0)
    return false;

  std::vector<double> pos(3 * n);
  for (int i = 0; i < 3 * n; ++i) pos[i] = pos_ang[i] * kBohrPerAngstrom;

  const int norb = mol.n_orb;
  mol.hcore.assign(norb * norb, 0.0);
  mol.e_nuc = 0.0;
  std::vector<Derived> der(n);
  for (int i = 0; i < n; ++i) der[i] = derived_params(*mol.el[i]);
  for (int a = 0; a < n; ++a) {
    const Elem& ea = *mol.el[a];
    const int oa = mol.offset[a], sa = mol.size[a];
    mol.hcore[oa * norb + oa] = ea.uss / kEvPerHartree;
    for (int k = 1; k < (sa < 4 ? sa : 4); ++k)
      mol.hcore[(oa + k) * norb + oa + k] = ea.upp / kEvPerHartree;
    for (int k = 4; k < sa; ++k)
      mol.hcore[(oa + k) * norb + oa + k] = ea.udd / kEvPerHartree;
  }
  for (int a = 0; a < n; ++a) {
    const Elem& ea = *mol.el[a];
    const int oa = mol.offset[a], sa = mol.size[a];
    for (int b = a + 1; b < n; ++b) {
      const Elem& eb = *mol.el[b];
      const int ob = mol.offset[b], sb = mol.size[b];
      double rvec[3] = {pos[3 * b] - pos[3 * a], pos[3 * b + 1] - pos[3 * a + 1],
                        pos[3 * b + 2] - pos[3 * a + 2]};
      const double r = std::sqrt(rvec[0] * rvec[0] + rvec[1] * rvec[1] +
                                 rvec[2] * rvec[2]);
      if (r < 1e-6) return false;
      double u[3][3];
      local_frame(rvec, u);
      mol.pairs.emplace_back(a, b);
      mol.eri2c.emplace_back();
      std::vector<double>& tv = mol.eri2c.back();
      if (ea.has_d || eb.has_d) {
        double wa[9][9], wb[9][9];
        orbital_rotation(u, sa, wa);
        orbital_rotation(u, sb, wb);
        two_center_eri_generic(ea, eb, r, tv);
        rotate_eri_generic(tv, sa, sb, wa, wb);
      } else {
        double w[4][4];
        std::memset(w, 0, sizeof(w));
        w[0][0] = 1.0;
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j) w[1 + i][1 + j] = u[i][j];
        double m_loc[10][10];
        eri_local(ea, der[a], eb, der[b], r, m_loc);
        double t4[4][4][4][4];
        rotate_eri(m_loc, w, t4);
        tv.resize(size_t(sa) * sa * sb * sb);
        for (int i = 0; i < sa; ++i)
          for (int j = 0; j < sa; ++j)
            for (int k = 0; k < sb; ++k)
              for (int l = 0; l < sb; ++l)
                tv[((size_t(i) * sa + j) * sb + k) * sb + l] = t4[i][j][k][l];
      }
      auto tat = [&](int i, int j, int k, int l) {
        return tv[((size_t(i) * sa + j) * sb + k) * sb + l];
      };
      // core-electron attraction
      for (int i = 0; i < sa; ++i)
        for (int j = 0; j < sa; ++j)
          mol.hcore[(oa + i) * norb + oa + j] -= eb.zval * tat(i, j, 0, 0);
      for (int k = 0; k < sb; ++k)
        for (int l = 0; l < sb; ++l)
          mol.hcore[(ob + k) * norb + ob + l] -= ea.zval * tat(0, 0, k, l);
      // resonance: generic sigma/pi/delta local overlap block
      static const int kLmOrbs[3][3][2] = {  // [l][m] -> local orbital ids
          {{0, -1}, {-1, -1}, {-1, -1}},
          {{3, -1}, {1, 2}, {-1, -1}},
          {{4, -1}, {5, 6}, {7, 8}}};
      double s_loc[9][9];
      std::memset(s_loc, 0, sizeof(s_loc));
      const double zeta_a[3] = {ea.zs, ea.zp, ea.zd};
      const double zeta_b[3] = {eb.zs, eb.zp, eb.zd};
      const int lmax_a = ea.has_d ? 2 : (ea.has_p ? 1 : 0);
      const int lmax_b = eb.has_d ? 2 : (eb.has_p ? 1 : 0);
      for (int la2 = 0; la2 <= lmax_a; ++la2)
        for (int lb2 = 0; lb2 <= lmax_b; ++lb2)
          for (int m = 0; m <= (la2 < lb2 ? la2 : lb2); ++m) {
            const double v = sto_overlap(ea.n, la2, zeta_a[la2], eb.n, lb2,
                                         zeta_b[lb2], m, r);
            for (int c = 0; c < (m == 0 ? 1 : 2); ++c)
              s_loc[kLmOrbs[la2][m][c]][kLmOrbs[lb2][m][c]] = v;
          }
      double wa9[9][9], wb9[9][9];
      orbital_rotation(u, sa, wa9);
      orbital_rotation(u, sb, wb9);
      const double beta_a[9] = {ea.beta_s, ea.beta_p, ea.beta_p, ea.beta_p,
                                ea.beta_d, ea.beta_d, ea.beta_d, ea.beta_d,
                                ea.beta_d};
      const double beta_b[9] = {eb.beta_s, eb.beta_p, eb.beta_p, eb.beta_p,
                                eb.beta_d, eb.beta_d, eb.beta_d, eb.beta_d,
                                eb.beta_d};
      for (int i = 0; i < sa; ++i)
        for (int j = 0; j < sb; ++j) {
          double s_glob = 0.0;
          for (int k = 0; k < sa; ++k)
            for (int l = 0; l < sb; ++l)
              s_glob += wa9[i][k] * s_loc[k][l] * wb9[j][l];
          const double res =
              0.5 * (beta_a[i] + beta_b[j]) / kEvPerHartree * s_glob;
          mol.hcore[(oa + i) * norb + ob + j] = res;
          mol.hcore[(ob + j) * norb + oa + i] = res;
        }
      mol.e_nuc += core_core(ea, eb, r, tat(0, 0, 0, 0));
    }
  }
  // one-center ERIs (exact dims per atom)
  mol.eri1c.resize(n);
  for (int a = 0; a < n; ++a) {
    const Elem& e = *mol.el[a];
    const int s = mol.size[a];
    std::vector<double>& tv = mol.eri1c[a];
    if (e.has_d) {
      tv.resize(6561);
      one_center_eri_spd(e, tv.data());
      continue;
    }
    tv.assign(size_t(s) * s * s * s, 0.0);
    auto at = [&](int i, int j, int k, int l) -> double& {
      return tv[((size_t(i) * s + j) * s + k) * s + l];
    };
    const double g = 1.0 / kEvPerHartree;
    at(0, 0, 0, 0) = e.gss * g;
    if (e.has_p) {
      const double hpp = 0.5 * (e.gpp - e.gp2);
      for (int i = 1; i < 4; ++i) {
        at(0, 0, i, i) = at(i, i, 0, 0) = e.gsp * g;
        at(i, i, i, i) = e.gpp * g;
        at(0, i, 0, i) = at(i, 0, 0, i) = e.hsp * g;
        at(0, i, i, 0) = at(i, 0, i, 0) = e.hsp * g;
        for (int j = 1; j < 4; ++j)
          if (i != j) {
            at(i, i, j, j) = e.gp2 * g;
            at(i, j, i, j) = at(i, j, j, i) = hpp * g;
          }
      }
    }
  }
  mol.ok = true;
  return true;
}

static void fock(const Molecule& mol, const double* p_tot,
                 const double* p_spin, double* f) {
  const int norb = mol.n_orb;
  std::memcpy(f, mol.hcore.data(), sizeof(double) * norb * norb);
  for (int a = 0; a < mol.n_atoms; ++a) {
    const int o = mol.offset[a], s = mol.size[a];
    const double* t = mol.eri1c[a].data();
    auto at = [&](int i, int j, int k, int l) {
      return t[((size_t(i) * s + j) * s + k) * s + l];
    };
    for (int m = 0; m < s; ++m)
      for (int nn = 0; nn < s; ++nn) {
        double acc = 0.0;
        for (int l = 0; l < s; ++l)
          for (int ss = 0; ss < s; ++ss)
            acc += at(m, nn, l, ss) * p_tot[(o + l) * norb + o + ss] -
                   at(m, l, nn, ss) * p_spin[(o + l) * norb + o + ss];
        f[(o + m) * norb + o + nn] += acc;
      }
  }
  for (size_t pi = 0; pi < mol.pairs.size(); ++pi) {
    const int a = mol.pairs[pi].first, b = mol.pairs[pi].second;
    const int oa = mol.offset[a], sa = mol.size[a];
    const int ob = mol.offset[b], sb = mol.size[b];
    const double* t = mol.eri2c[pi].data();
    auto at = [&](int i, int j, int k, int l) {
      return t[((size_t(i) * sa + j) * sb + k) * sb + l];
    };
    for (int m = 0; m < sa; ++m)
      for (int nn = 0; nn < sa; ++nn) {
        double acc = 0.0;
        for (int l = 0; l < sb; ++l)
          for (int ss = 0; ss < sb; ++ss)
            acc += at(m, nn, l, ss) * p_tot[(ob + l) * norb + ob + ss];
        f[(oa + m) * norb + oa + nn] += acc;
      }
    for (int l = 0; l < sb; ++l)
      for (int ss = 0; ss < sb; ++ss) {
        double acc = 0.0;
        for (int m = 0; m < sa; ++m)
          for (int nn = 0; nn < sa; ++nn)
            acc += at(m, nn, l, ss) * p_tot[(oa + m) * norb + oa + nn];
        f[(ob + l) * norb + ob + ss] += acc;
      }
    for (int m = 0; m < sa; ++m)
      for (int l = 0; l < sb; ++l) {
        double acc = 0.0;
        for (int nn = 0; nn < sa; ++nn)
          for (int ss = 0; ss < sb; ++ss)
            acc += at(m, nn, l, ss) * p_spin[(oa + nn) * norb + ob + ss];
        f[(oa + m) * norb + ob + l] -= acc;
        f[(ob + l) * norb + oa + m] = f[(oa + m) * norb + ob + l];
      }
  }
}

static void density(const double* f, int n, int nocc, double* p) {
  std::vector<double> w, v;
  eigh(f, n, w, v);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      double acc = 0.0;
      for (int k = 0; k < nocc; ++k) acc += v[i * n + k] * v[j * n + k];
      p[i * n + j] = acc;
    }
}

// UHF SCF; returns total energy in Hartree, sets *converged; optionally
// exports the converged spin densities (for the frozen-density gradients)
// and accepts an initial-density guess for the leading guess_norb orbitals
// (warm start from a parent geometry; the rest gets the standard guess).
static double scf(const Molecule& mol, bool* converged,
                  std::vector<double>* pa_out = nullptr,
                  std::vector<double>* pb_out = nullptr,
                  const double* pa_guess = nullptr,
                  const double* pb_guess = nullptr, int guess_norb = 0,
                  int max_iter = 500) {
  const int norb = mol.n_orb;
  const int nn = norb * norb;
  std::vector<double> pa(nn, 0.0), pb(nn, 0.0);
  for (int a = 0; a < mol.n_atoms; ++a) {
    const int o = mol.offset[a];
    // guess spreads the valence charge over the sp shell only: the d shell
    // of a second-row ground state is empty (mirrors nddo_ref.py scf)
    const int s = mol.size[a] < 4 ? mol.size[a] : 4;
    for (int k = 0; k < s; ++k) {
      const double occ = mol.el[a]->zval / s;
      pa[(o + k) * norb + o + k] = (mol.n_beta == 0) ? occ : 0.5 * occ;
      pb[(o + k) * norb + o + k] = (mol.n_beta == 0) ? 0.0 : 0.5 * occ;
    }
  }
  if (pa_guess && guess_norb > 0 && guess_norb <= norb) {
    // overwrite the leading block with the parent's converged density; the
    // guess only seeds the first Fock build (aufbau re-occupation every
    // iteration fixes the electron count), so an approximate trace is fine
    for (int i = 0; i < guess_norb; ++i)
      for (int j = 0; j < guess_norb; ++j) {
        pa[i * norb + j] = pa_guess[i * guess_norb + j];
        pb[i * norb + j] = pb_guess[i * guess_norb + j];
      }
  }
  std::vector<double> fa(nn), fb(nn), ptot(nn), pa_new(nn), pb_new(nn);
  // DIIS history 20, not 8: near-degenerate clusters (e.g. an O3NF chain
  // from the random-molecule parity test) need the larger subspace — with
  // 8 they stall at a NON-stationary plateau (err ~1e-5, [F,P] frozen by
  // the level shift) whose acceptance was machine-FP-dependent; with 20
  // the same system converges tightly (err < 1e-7) in ~110 iterations.
  // Cost: ~1 MB extra history and a 21x21 B-matrix solve per iteration —
  // negligible. Mirrors nddo_ref.py scf.
  constexpr int kDiisMax = 20;
  std::vector<std::vector<double>> diis_err, diis_fa, diis_fb;
  double e_prev = 0.0;
  *converged = false;
  double e_elec = 0.0;
  // Three deterministic phases: plain DIIS; DIIS restart + damping + level
  // shift; heavier damping — small-gap systems otherwise oscillate at
  // err ~1e-5 forever (mirrors nddo_ref.py scf exactly).
  //
  // Negative result (measured, round 3): extending the ladder past 500 with
  // alternating shifted/plain phases converges more random knife-edge
  // clusters in isolation (35/40 vs 30/40) but destroys cross-
  // implementation reproducibility — after 500+ near-chaotic DIIS
  // iterations the C++ and numpy-oracle trajectories separate into
  // different UHF basins (converged-value gaps up to 0.16 Ha, 5 outcome
  // mismatches vs 3). The ladder deliberately stops at 500; see
  // nddo_ref.py SCF_PHASES for the full note.
  double shift = 0.0, mix_floor = 1.0;
  int flat_count = 0;
  static const bool debug = std::getenv("MOLGYM_SCF_DEBUG") != nullptr;
  for (int it = 0; it < max_iter; ++it) {
    if (it == 200 || it == 350) {
      diis_err.clear();
      diis_fa.clear();
      diis_fb.clear();
      shift = it == 200 ? 0.5 : 1.0;
      mix_floor = it == 200 ? 0.35 : 0.2;
    }
    for (int i = 0; i < nn; ++i) ptot[i] = pa[i] + pb[i];
    fock(mol, ptot.data(), pa.data(), fa.data());
    fock(mol, ptot.data(), pb.data(), fb.data());
    e_elec = 0.0;
    for (int i = 0; i < nn; ++i)
      e_elec += 0.5 * (pa[i] * (mol.hcore[i] + fa[i]) +
                       pb[i] * (mol.hcore[i] + fb[i]));
    // DIIS error = [F, P] per spin
    std::vector<double> err(2 * nn, 0.0);
    double err_norm = 0.0;
    for (int i = 0; i < norb; ++i)
      for (int j = 0; j < norb; ++j) {
        double ca = 0.0, cb = 0.0;
        for (int k = 0; k < norb; ++k) {
          ca += fa[i * norb + k] * pa[k * norb + j] -
                pa[i * norb + k] * fa[k * norb + j];
          cb += fb[i * norb + k] * pb[k * norb + j] -
                pb[i * norb + k] * fb[k * norb + j];
        }
        err[i * norb + j] = ca;
        err[nn + i * norb + j] = cb;
        err_norm = std::max(err_norm, std::max(std::fabs(ca), std::fabs(cb)));
      }
    // primary: tight commutator; secondary: energy flat 5 consecutive
    // iterations with a loose commutator (energy error is O(err^2); see
    // nddo_ref.py scf for the rationale)
    if (debug && (it < 10 || it % 25 == 0))
      std::fprintf(stderr, "scf it=%d e=%.14f err=%.3e\n", it, e_elec,
                   err_norm);
    // flat threshold 1e-11, not 1e-12: near-degenerate radicals (e.g. the
    // NS doublet at 1.6 A) can CREEP at ~7e-12 Ha/iteration with err stuck
    // at ~2e-6 — whether that drift sits above or below 1e-12 depends on
    // the compiler's FP contraction, so 1e-12 made convergence
    // machine-dependent. The energy error at err 1e-5 is O(err^2) ~ 1e-10,
    // far below the 1e-8 golden tolerance. Mirrors nddo_ref.py scf.
    const bool flat = std::fabs(e_elec - e_prev) < 1e-11;
    flat_count = flat ? flat_count + 1 : 0;
    if (it > 1 && flat &&
        (err_norm < 1e-7 || (flat_count >= 5 && err_norm < 1e-5))) {
      *converged = true;
      break;
    }
    e_prev = e_elec;
    diis_err.push_back(err);
    diis_fa.push_back(fa);
    diis_fb.push_back(fb);
    if ((int)diis_err.size() > kDiisMax) {
      diis_err.erase(diis_err.begin());
      diis_fa.erase(diis_fa.begin());
      diis_fb.erase(diis_fb.begin());
    }
    const int k = (int)diis_err.size();
    if (k >= 2) {
      std::vector<double> bmat((k + 1) * (k + 1)), rhs(k + 1, 0.0);
      for (int i = 0; i < k; ++i)
        for (int j = 0; j < k; ++j) {
          double dot = 0.0;
          for (int m = 0; m < 2 * nn; ++m) dot += diis_err[i][m] * diis_err[j][m];
          bmat[i * (k + 1) + j] = dot;
        }
      for (int i = 0; i <= k; ++i) {
        bmat[i * (k + 1) + k] = -1.0;
        bmat[k * (k + 1) + i] = -1.0;
      }
      bmat[k * (k + 1) + k] = 0.0;
      rhs[k] = -1.0;
      // gaussian elimination with partial pivoting
      const int dim = k + 1;
      bool singular = false;
      for (int col = 0; col < dim; ++col) {
        int piv = col;
        for (int r = col + 1; r < dim; ++r)
          if (std::fabs(bmat[r * dim + col]) > std::fabs(bmat[piv * dim + col]))
            piv = r;
        if (std::fabs(bmat[piv * dim + col]) < 1e-14) {
          singular = true;
          break;
        }
        if (piv != col) {
          for (int c = 0; c < dim; ++c)
            std::swap(bmat[col * dim + c], bmat[piv * dim + c]);
          std::swap(rhs[col], rhs[piv]);
        }
        for (int r = col + 1; r < dim; ++r) {
          const double fac = bmat[r * dim + col] / bmat[col * dim + col];
          for (int c = col; c < dim; ++c) bmat[r * dim + c] -= fac * bmat[col * dim + c];
          rhs[r] -= fac * rhs[col];
        }
      }
      if (!singular) {
        std::vector<double> coef(dim);
        for (int r = dim - 1; r >= 0; --r) {
          double acc = rhs[r];
          for (int c = r + 1; c < dim; ++c) acc -= bmat[r * dim + c] * coef[c];
          coef[r] = acc / bmat[r * dim + r];
        }
        std::fill(fa.begin(), fa.end(), 0.0);
        std::fill(fb.begin(), fb.end(), 0.0);
        for (int i = 0; i < k; ++i)
          for (int m = 0; m < nn; ++m) {
            fa[m] += coef[i] * diis_fa[i][m];
            fb[m] += coef[i] * diis_fb[i][m];
          }
      }
    }
    if (shift > 0.0) {  // level shift: F + shift (I - P) before diagonalizing
      std::vector<double> fa_d(fa), fb_d(fb);
      for (int i = 0; i < norb; ++i)
        for (int j = 0; j < norb; ++j) {
          const double delta = (i == j) ? 1.0 : 0.0;
          fa_d[i * norb + j] += shift * (delta - pa[i * norb + j]);
          fb_d[i * norb + j] += shift * (delta - pb[i * norb + j]);
        }
      density(fa_d.data(), norb, mol.n_alpha, pa_new.data());
      if (mol.n_beta > 0)
        density(fb_d.data(), norb, mol.n_beta, pb_new.data());
      else
        std::fill(pb_new.begin(), pb_new.end(), 0.0);
    } else {
      density(fa.data(), norb, mol.n_alpha, pa_new.data());
      if (mol.n_beta > 0)
        density(fb.data(), norb, mol.n_beta, pb_new.data());
      else
        std::fill(pb_new.begin(), pb_new.end(), 0.0);
    }
    const double mix = std::min(it < 4 ? 0.7 : 1.0, mix_floor);
    for (int i = 0; i < nn; ++i) {
      pa[i] = mix * pa_new[i] + (1.0 - mix) * pa[i];
      pb[i] = mix * pb_new[i] + (1.0 - mix) * pb[i];
    }
  }
  if (pa_out) *pa_out = pa;
  if (pb_out) *pb_out = pb;
  return e_elec + mol.e_nuc;
}

// Total energy of a geometry evaluated with a FROZEN density (one Fock build,
// no SCF): E = 1/2 sum[pa (h + fa) + pb (h + fb)] + e_nuc.
static double frozen_density_energy(const Molecule& mol,
                                    const std::vector<double>& pa,
                                    const std::vector<double>& pb) {
  const int nn = mol.n_orb * mol.n_orb;
  std::vector<double> ptot(nn), fa(nn), fb(nn);
  for (int i = 0; i < nn; ++i) ptot[i] = pa[i] + pb[i];
  fock(mol, ptot.data(), pa.data(), fa.data());
  fock(mol, ptot.data(), pb.data(), fb.data());
  double e = 0.0;
  for (int i = 0; i < nn; ++i)
    e += 0.5 * (pa[i] * (mol.hcore[i] + fa[i]) +
                pb[i] * (mol.hcore[i] + fb[i]));
  return e + mol.e_nuc;
}

// Converged-density cache for SCF warm starts. The RL canvas is append-only
// (atoms never move once placed), so the molecule evaluated at step t is the
// step t-1 molecule plus one atom: seeding the SCF with the parent's
// converged density block cuts the iteration count severalfold. Keys are
// exact geometry bytes (FNV-1a); capped by total bytes, cleared on overflow
// (correctness-free: only the warm start is lost). Entries carry a second,
// independent hash of the key bytes verified on lookup, so a primary-hash
// collision cannot silently seed the SCF with an unrelated density.
struct DensityCache {
  std::mutex mu;
  struct Entry {
    uint64_t check;  // secondary hash, verified on lookup
    int norb;
    std::vector<double> pa, pb;
  };
  std::unordered_map<uint64_t, Entry> map;
  size_t bytes = 0;

  struct Key {
    uint64_t k, check;
  };

  static Key key(const int* zs, const double* pos, int n, int charge,
                 int mult) {
    uint64_t h1 = 1469598103934665603ull;  // FNV-1a
    uint64_t h2 = 0x9e3779b97f4a7c15ull;   // independent splitmix-style mix
    auto mix = [&h1, &h2](const void* p, size_t len) {
      const unsigned char* c = static_cast<const unsigned char*>(p);
      for (size_t i = 0; i < len; ++i) {
        h1 ^= c[i];
        h1 *= 1099511628211ull;
        h2 += c[i];
        h2 ^= h2 >> 30;
        h2 *= 0xbf58476d1ce4e5b9ull;
      }
    };
    mix(&n, sizeof(n));
    mix(&charge, sizeof(charge));
    mix(&mult, sizeof(mult));
    mix(zs, sizeof(int) * n);
    mix(pos, sizeof(double) * 3 * n);
    return Key{h1, h2};
  }
};

static DensityCache& density_cache() {
  static DensityCache c;
  return c;
}

static double nddo_energy(const int* zs, const double* pos, int n, int charge,
                          int multiplicity, bool* converged) {
  *converged = false;
  if (n <= 0) return 0.0;
  Molecule mol;
  if (!build(mol, zs, pos, n, charge, multiplicity)) return NAN;

  // SCF warm starts are OFF by default (opt-in via MOLGYM_SCF_WARMSTART=1):
  // UHF has multiple stationary points, and seeding from the parent
  // fragment's (possibly spin-polarized) density can converge to a
  // DIFFERENT solution than a cold start — observed concretely on Cl2,
  // where a warm start from the Cl-atom doublet density lands ~4 kcal/mol
  // above the cold-start solution, making the energy depend on evaluation
  // history. Round-2 measurements also showed no rollout-throughput gain
  // from the warm start (the rollout is dispatch-bound once the energy
  // cache is in place), so correctness wins by default.
  static const bool kWarmStart = [] {
    const char* v = std::getenv("MOLGYM_SCF_WARMSTART");
    return v != nullptr && v[0] == '1';
  }();
  DensityCache& dc = density_cache();
  std::vector<double> pa_guess, pb_guess;
  int guess_norb = 0;
  if (kWarmStart && n > 1) {
    // the parent geometry is the first n-1 atoms (canvas is append-only;
    // it was evaluated with the same charge/multiplicity arguments)
    const DensityCache::Key pkey = DensityCache::key(zs, pos, n - 1, charge,
                                                     multiplicity);
    std::lock_guard<std::mutex> lock(dc.mu);
    auto it = dc.map.find(pkey.k);
    if (it != dc.map.end() && it->second.check == pkey.check) {
      guess_norb = it->second.norb;
      pa_guess = it->second.pa;
      pb_guess = it->second.pb;
    }
  }
  std::vector<double> pa_out, pb_out;
  const double e = scf(mol, converged, &pa_out, &pb_out,
                       guess_norb ? pa_guess.data() : nullptr,
                       guess_norb ? pb_guess.data() : nullptr, guess_norb);
  if (kWarmStart && *converged) {
    const DensityCache::Key k = DensityCache::key(zs, pos, n, charge,
                                                  multiplicity);
    std::lock_guard<std::mutex> lock(dc.mu);
    const size_t entry_bytes = pa_out.size() * 2 * sizeof(double);
    if (dc.bytes + entry_bytes > size_t(128) << 20) {  // 128 MB cap
      dc.map.clear();
      dc.bytes = 0;
    }
    if (dc.map.emplace(k.k,
                       DensityCache::Entry{k.check, mol.n_orb,
                                           std::move(pa_out),
                                           std::move(pb_out)}).second)
      dc.bytes += entry_bytes;
  }
  return *converged ? e : NAN;
}

}  // namespace nddo

extern "C" {

// Total PM6 energy in Hartree; positions in Angstrom. multiplicity <= 0 means
// the reference's rule (sum Z) % 2 + 1 (molgym/reward.py:17-19). Returns NaN
// if an element is unsupported or the SCF fails to converge.
double mg_nddo_energy(const int* zs, const double* positions, int n,
                      int charge, int multiplicity) {
  bool conv = false;
  return nddo::nddo_energy(zs, positions, n, charge, multiplicity, &conv);
}

// Central finite-difference gradients in Hartree/bohr. Returns 0 on success.
//
// Frozen-density scheme: ONE SCF at the reference geometry, then each
// displaced energy is a single integral build + Fock contraction with the
// converged density held fixed. Exact to O(step^2): the NDDO basis is
// orthogonal (no overlap/Pulay terms) and E is variationally stationary in
// P, so dP/dR contributes nothing to first order. ~n_scf_iter x faster than
// re-solving the SCF per displacement.
int mg_nddo_gradients(const int* zs, const double* positions, int n,
                      int charge, int multiplicity, double* grad) {
  const double step = 2e-4;  // Angstrom
  nddo::Molecule mol0;
  if (!nddo::build(mol0, zs, positions, n, charge, multiplicity)) return 1;
  bool conv = false;
  std::vector<double> pa, pb;
  nddo::scf(mol0, &conv, &pa, &pb);
  if (!conv) return 1;
  std::vector<double> work(positions, positions + 3 * n);
  for (int i = 0; i < 3 * n; ++i) {
    work[i] = positions[i] + step;
    nddo::Molecule mp;
    if (!nddo::build(mp, zs, work.data(), n, charge, multiplicity)) return 1;
    const double ep = nddo::frozen_density_energy(mp, pa, pb);
    work[i] = positions[i] - step;
    nddo::Molecule mm;
    if (!nddo::build(mm, zs, work.data(), n, charge, multiplicity)) return 1;
    const double em = nddo::frozen_density_energy(mm, pa, pb);
    work[i] = positions[i];
    grad[i] = (ep - em) / (2.0 * step * nddo::kBohrPerAngstrom);
  }
  return 0;
}

// 1 if PM6 parameters exist for atomic number z
int mg_nddo_supported(int z) { return nddo::elem(z) != nullptr ? 1 : 0; }

// Converged UHF spin densities (row-major [norb, norb] each) + total energy.
// Exists for cross-implementation FUNCTIONAL-parity checks
// (tests/test_nddo.py): on near-degenerate clusters the C++ and numpy-oracle
// SCF trajectories can land in different UHF basins depending on machine FP
// (both genuine stationary points); exporting the converged density lets the
// oracle evaluate ITS energy functional on OUR solution, which is the
// implementation-independent parity statement. cap = caller buffer size in
// doubles per spin (needs norb^2). Returns 0 ok, 1 bad molecule, 2 buffer
// too small, 3 SCF not converged; *norb_out is set whenever build succeeds.
int mg_nddo_scf_density(const int* zs, const double* positions, int n,
                        int charge, int multiplicity, int cap,
                        double* pa_out, double* pb_out, int* norb_out,
                        double* energy_out) {
  nddo::Molecule mol;
  if (!nddo::build(mol, zs, positions, n, charge, multiplicity)) return 1;
  if (norb_out) *norb_out = mol.n_orb;
  if (mol.n_orb * mol.n_orb > cap) return 2;
  bool conv = false;
  std::vector<double> pa, pb;
  const double e = nddo::scf(mol, &conv, &pa, &pb);
  if (!conv) return 3;
  std::copy(pa.begin(), pa.end(), pa_out);
  std::copy(pb.begin(), pb.end(), pb_out);
  if (energy_out) *energy_out = e;
  return 0;
}

}  // extern "C"
