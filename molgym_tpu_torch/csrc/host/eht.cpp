// Extended Hückel theory (EHT) backend: a real (non-self-consistent)
// electronic-structure method implemented natively, giving the framework a
// quantum-mechanical reward surface without external dependencies.
//
//   * minimal valence basis of contracted Gaussians (STO-3G-style s/p shells)
//   * overlap matrix via the Gaussian product theorem (s-s, s-p, p-p)
//   * H_ii = -VSIP (Hoffmann parameters), H_ij = K/2 (H_ii+H_jj) S_ij, K=1.75
//   * generalized eigenproblem H C = S C e via symmetric orthogonalization
//     (S^-1/2 from a Jacobi eigensolver)
//   * electronic energy = sum over occupied orbital energies (aufbau)
//   * a pairwise Born-Mayer core repulsion A exp(-r/rho) (bare EHT has no
//     nuclear repulsion and would collapse) calibrated against covalent radii
//
// Supported elements: H, C, N, O, F, S (the molecular-design envs' palette).
// Energies are in Hartree; geometry in Angstrom at the C ABI, converted here.

#include <cmath>
#include <cstring>
#include <vector>

namespace eht {

constexpr double kBohrPerAngstrom = 1.8897261258369282;
constexpr double kEvToHartree = 1.0 / 27.211386245988;
constexpr double kWolfsberg = 1.75;
constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// Basis: contracted Gaussians. Each shell = 3 primitives.
// STO-3G exponents/contractions (s and p share exponents for 2sp/3sp shells).
// ---------------------------------------------------------------------------
struct Shell {
  int l;                 // 0 = s, 1 = p
  double exps[3];
  double coefs[3];
  double h_ii_ev;        // -VSIP for this shell (eV, negative)
};

struct ElementBasis {
  int n_shells = 0;
  Shell shells[2];
  int valence_electrons = 0;
  double repulsion_radius = 0.0;  // covalent radius (Angstrom)
};

// returns basis or nullptr if unsupported
struct BasisTable {
  ElementBasis H, C, N, O, F, S, Cl, Br;
};

// thread-safe: C++11 magic-static initialization (the first EHT evaluation
// runs concurrently on the host thread pool)
const BasisTable& basis_table() {
  static const BasisTable table = [] {
    BasisTable t;
    ElementBasis &H = t.H, &C = t.C, &N = t.N, &O = t.O, &F = t.F, &S = t.S;
    ElementBasis& Cl = t.Cl;
    H.n_shells = 1;
    H.valence_electrons = 1;
    H.repulsion_radius = 0.31;
    H.shells[0] = {0,
                   {3.42525091, 0.62391373, 0.16885540},
                   {0.15432897, 0.53532814, 0.44463454},
                   -13.6};

    auto sp_row = [](ElementBasis& e, double a1, double a2, double a3,
                     double hs, double hp, int nval, double rcov) {
      e.n_shells = 2;
      e.valence_electrons = nval;
      e.repulsion_radius = rcov;
      e.shells[0] = {0, {a1, a2, a3},
                     {-0.09996723, 0.39951283, 0.70011547}, hs};
      e.shells[1] = {1, {a1, a2, a3},
                     {0.15591627, 0.60768372, 0.39195739}, hp};
    };
    sp_row(C, 2.9412494, 0.6834831, 0.2222899, -21.4, -11.4, 4, 0.76);
    sp_row(N, 3.7804559, 0.8784966, 0.2857144, -26.0, -13.4, 5, 0.71);
    sp_row(O, 5.0331513, 1.1695961, 0.3803890, -32.3, -14.8, 6, 0.66);
    sp_row(F, 6.4648032, 1.4971414, 0.4885885, -40.0, -18.1, 7, 0.57);
    // S 3sp (STO-3G third-row sp contraction)
    S.n_shells = 2;
    S.valence_electrons = 6;
    S.repulsion_radius = 1.05;
    S.shells[0] = {0, {2.0291942, 0.5661400, 0.2215833},
                   {-0.21962037, 0.22559543, 0.90039843}, -20.0};
    S.shells[1] = {1, {2.0291942, 0.5661400, 0.2215833},
                   {0.01058760, 0.59516701, 0.46200101}, -11.0};
    // Cl 3sp: same STO-3G third-row contraction scaled to zeta = 2.356
    // (S row's base exponents x zeta^2); VSIP -30.0 / -15.0 eV (standard
    // EHT chlorine parameters)
    Cl.n_shells = 2;
    Cl.valence_electrons = 7;
    Cl.repulsion_radius = 1.02;
    Cl.shells[0] = {0, {2.5014600, 0.6978800, 0.2731460},
                    {-0.21962037, 0.22559543, 0.90039843}, -30.0};
    Cl.shells[1] = {1, {2.5014600, 0.6978800, 0.2731460},
                    {0.01058760, 0.59516701, 0.46200101}, -15.0};
    // Br 4sp: same third-row contraction shape scaled to zeta = 2.30
    // (between the standard EHT 4s/4p Slater exponents 2.588/2.131 —
    // shared-exponent sp shells force one zeta); VSIP -22.07 / -13.10 eV
    // (standard extended-Hueckel bromine parameters)
    ElementBasis& Br = t.Br;
    Br.n_shells = 2;
    Br.valence_electrons = 7;
    Br.repulsion_radius = 1.20;
    Br.shells[0] = {0, {2.3841075, 0.6651152, 0.2603401},
                    {-0.21962037, 0.22559543, 0.90039843}, -22.07};
    Br.shells[1] = {1, {2.3841075, 0.6651152, 0.2603401},
                    {0.01058760, 0.59516701, 0.46200101}, -13.10};
    return t;
  }();
  return table;
}

const ElementBasis* element_basis(int z) {
  const BasisTable& t = basis_table();
  switch (z) {
    case 1: return &t.H;
    case 6: return &t.C;
    case 7: return &t.N;
    case 8: return &t.O;
    case 9: return &t.F;
    case 16: return &t.S;
    case 17: return &t.Cl;
    case 35: return &t.Br;
    default: return nullptr;
  }
}

// ---------------------------------------------------------------------------
// Primitive Gaussian overlaps (normalized primitives).
//   s(a) s(b):   (pi/(a+b))^1.5 exp(-mu r^2) * Na * Nb
//   p_i(a) s(b): derivative forms via Gaussian product center
// ---------------------------------------------------------------------------
inline double norm_s(double a) { return std::pow(2.0 * a / kPi, 0.75); }
inline double norm_p(double a) {
  return std::pow(2.0 * a / kPi, 0.75) * 2.0 * std::sqrt(a);
}

// overlap of two primitives with angular momenta (la, ia) and (lb, ib)
// where i* is the Cartesian component (0..2) for p, ignored for s.
// AB = A - B (Bohr).
inline double prim_overlap(int la, int ia, double a, int lb, int ib, double b,
                           const double* AB) {
  const double p = a + b;
  const double r2 = AB[0] * AB[0] + AB[1] * AB[1] + AB[2] * AB[2];
  const double base = std::pow(kPi / p, 1.5) * std::exp(-a * b / p * r2);
  // P - A = -(b/p) AB ; P - B = (a/p) AB
  if (la == 0 && lb == 0) {
    return norm_s(a) * norm_s(b) * base;
  }
  if (la == 1 && lb == 0) {
    const double pa = -(b / p) * AB[ia];
    return norm_p(a) * norm_s(b) * pa * base;
  }
  if (la == 0 && lb == 1) {
    const double pb = (a / p) * AB[ib];
    return norm_s(a) * norm_p(b) * pb * base;
  }
  // p-p
  const double pa = -(b / p) * AB[ia];
  const double pb = (a / p) * AB[ib];
  double val = pa * pb;
  if (ia == ib) val += 1.0 / (2.0 * p);
  return norm_p(a) * norm_p(b) * val * base;
}

struct AO {
  const Shell* shell;
  int comp;      // cartesian component for p (0..2); 0 for s
  int atom;
  double pos[3];  // Bohr
  double self_norm;  // contracted self-overlap for normalization
};

inline double contracted_overlap(const AO& x, const AO& y) {
  double AB[3] = {x.pos[0] - y.pos[0], x.pos[1] - y.pos[1],
                  x.pos[2] - y.pos[2]};
  const int la = x.shell->l, lb = y.shell->l;
  double s = 0.0;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      s += x.shell->coefs[i] * y.shell->coefs[j] *
           prim_overlap(la, x.comp, x.shell->exps[i], lb, y.comp,
                        y.shell->exps[j], AB);
    }
  }
  return s;
}

// ---------------------------------------------------------------------------
// Jacobi eigensolver for symmetric matrices (row-major, n x n).
// Returns eigenvalues in w (ascending) and eigenvectors in columns of V.
// ---------------------------------------------------------------------------
void jacobi_eigh(std::vector<double>& A, int n, std::vector<double>& w,
                 std::vector<double>& V) {
  V.assign(n * n, 0.0);
  for (int i = 0; i < n; ++i) V[i * n + i] = 1.0;
  for (int sweep = 0; sweep < 100; ++sweep) {
    double off = 0.0;
    for (int i = 0; i < n; ++i)
      for (int j = i + 1; j < n; ++j) off += A[i * n + j] * A[i * n + j];
    if (off < 1e-22) break;
    for (int p = 0; p < n; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = A[p * n + q];
        if (std::fabs(apq) < 1e-18) continue;
        const double theta = (A[q * n + q] - A[p * n + p]) / (2.0 * apq);
        const double t = (theta >= 0 ? 1.0 : -1.0) /
                         (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        const double c = 1.0 / std::sqrt(t * t + 1.0);
        const double s = t * c;
        for (int k = 0; k < n; ++k) {
          const double akp = A[k * n + p], akq = A[k * n + q];
          A[k * n + p] = c * akp - s * akq;
          A[k * n + q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {
          const double apk = A[p * n + k], aqk = A[q * n + k];
          A[p * n + k] = c * apk - s * aqk;
          A[q * n + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; ++k) {
          const double vkp = V[k * n + p], vkq = V[k * n + q];
          V[k * n + p] = c * vkp - s * vkq;
          V[k * n + q] = s * vkp + c * vkq;
        }
      }
    }
  }
  w.resize(n);
  for (int i = 0; i < n; ++i) w[i] = A[i * n + i];
  // sort ascending (insertion, n is small)
  for (int i = 1; i < n; ++i) {
    double wi = w[i];
    std::vector<double> vi(n);
    for (int k = 0; k < n; ++k) vi[k] = V[k * n + i];
    int j = i - 1;
    while (j >= 0 && w[j] > wi) {
      w[j + 1] = w[j];
      for (int k = 0; k < n; ++k) V[k * n + j + 1] = V[k * n + j];
      --j;
    }
    w[j + 1] = wi;
    for (int k = 0; k < n; ++k) V[k * n + j + 1] = vi[k];
  }
}

// ---------------------------------------------------------------------------
// Core-core repulsion: Born-Mayer A exp(-r / rho). Calibrated so diatomic
// minima land near the sum of covalent radii with well depths of a few tenths
// of a Hartree (comparable to the PM6 interaction magnitudes the envs use).
// ---------------------------------------------------------------------------
inline double core_repulsion(double r_bohr, double r0_ang) {
  const double r0 = r0_ang * kBohrPerAngstrom;
  const double rho = 0.18 * r0;
  const double A = 6.0;  // Hartree
  return A * std::exp(-(r_bohr - r0) / rho) * std::exp(-1.0 / 0.18);
}

// Orbital solve: sorted MO energies (Hartree) into `ew`, plus the valence
// electron count and core repulsion. Returns the orbital count (0 if no
// parameterized AOs). Shared by total_energy and the mg_eht_orbitals export.
int solve_orbitals(const int* zs, const double* pos_ang, int n_atoms,
                   std::vector<double>& ew, int* n_electrons_out,
                   double* e_rep_out) {
  ew.clear();
  *n_electrons_out = 0;
  *e_rep_out = 0.0;
  if (n_atoms <= 0) return 0;

  // Build AO list
  std::vector<AO> aos;
  int n_electrons = 0;
  for (int a = 0; a < n_atoms; ++a) {
    const ElementBasis* eb = element_basis(zs[a]);
    if (!eb) continue;
    n_electrons += eb->valence_electrons;
    for (int s = 0; s < eb->n_shells; ++s) {
      const Shell& sh = eb->shells[s];
      const int n_comp = sh.l == 0 ? 1 : 3;
      for (int comp = 0; comp < n_comp; ++comp) {
        AO ao;
        ao.shell = &sh;
        ao.comp = comp;
        ao.atom = a;
        for (int k = 0; k < 3; ++k)
          ao.pos[k] = pos_ang[3 * a + k] * kBohrPerAngstrom;
        ao.self_norm = 1.0;
        ao.self_norm = contracted_overlap(ao, ao);
        aos.push_back(ao);
      }
    }
  }

  double e_rep = 0.0;
  for (int i = 0; i < n_atoms; ++i) {
    const ElementBasis* ei = element_basis(zs[i]);
    for (int j = i + 1; j < n_atoms; ++j) {
      const ElementBasis* ej = element_basis(zs[j]);
      double d2 = 0.0;
      for (int k = 0; k < 3; ++k) {
        const double d = (pos_ang[3 * i + k] - pos_ang[3 * j + k]) *
                         kBohrPerAngstrom;
        d2 += d * d;
      }
      const double r = std::sqrt(std::max(d2, 1e-12));
      const double r0 = (ei ? ei->repulsion_radius : 1.0) +
                        (ej ? ej->repulsion_radius : 1.0);
      e_rep += core_repulsion(r, r0);
    }
  }

  const int n = static_cast<int>(aos.size());
  *n_electrons_out = n_electrons;
  *e_rep_out = e_rep;
  if (n == 0) return 0;

  // Overlap and Hamiltonian (normalized AOs)
  std::vector<double> S(n * n), Hm(n * n);
  for (int i = 0; i < n; ++i) {
    const double ni = 1.0 / std::sqrt(aos[i].self_norm);
    for (int j = i; j < n; ++j) {
      const double nj = 1.0 / std::sqrt(aos[j].self_norm);
      const double s = contracted_overlap(aos[i], aos[j]) * ni * nj;
      S[i * n + j] = S[j * n + i] = s;
      const double hi = aos[i].shell->h_ii_ev * kEvToHartree;
      const double hj = aos[j].shell->h_ii_ev * kEvToHartree;
      const double h = (i == j) ? hi
                                : 0.5 * kWolfsberg * (hi + hj) * s;
      Hm[i * n + j] = Hm[j * n + i] = h;
    }
  }

  // S^-1/2 via eigendecomposition (discard near-singular directions)
  std::vector<double> Scopy(S), sw, SV;
  jacobi_eigh(Scopy, n, sw, SV);
  std::vector<double> X(n * n, 0.0);  // X = U s^-1/2 U^T
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      double acc = 0.0;
      for (int k = 0; k < n; ++k) {
        if (sw[k] > 1e-8) {
          acc += SV[i * n + k] * SV[j * n + k] / std::sqrt(sw[k]);
        }
      }
      X[i * n + j] = acc;
    }
  }

  // H' = X^T H X (X symmetric)
  std::vector<double> T(n * n, 0.0), Hp(n * n, 0.0);
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < n; ++k) {
      const double hik = Hm[i * n + k];
      if (hik == 0.0) continue;
      for (int j = 0; j < n; ++j) T[i * n + j] += hik * X[k * n + j];
    }
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < n; ++k) {
      const double xki = X[k * n + i];
      if (xki == 0.0) continue;
      for (int j = 0; j < n; ++j) Hp[i * n + j] += xki * T[k * n + j];
    }

  std::vector<double> EV;
  jacobi_eigh(Hp, n, ew, EV);
  return n;
}

// Total EHT energy (Hartree). zs: atomic numbers; pos in ANGSTROM.
// Returns 0 for empty molecules; unsupported elements contribute only core
// repulsion (graceful degradation).
double total_energy(const int* zs, const double* pos_ang, int n_atoms) {
  std::vector<double> ew;
  int n_electrons = 0;
  double e_rep = 0.0;
  const int n = solve_orbitals(zs, pos_ang, n_atoms, ew, &n_electrons, &e_rep);
  if (n == 0 || n_electrons == 0) return e_rep;

  // Aufbau filling of valence electrons
  double e_elec = 0.0;
  int remaining = n_electrons;
  for (int i = 0; i < n && remaining > 0; ++i) {
    const int occ = remaining >= 2 ? 2 : 1;
    e_elec += occ * ew[i];
    remaining -= occ;
  }
  return e_elec + e_rep;
}

}  // namespace eht

extern "C" {
double mg_eht_energy(const int* zs, const double* positions, int n) {
  return eht::total_energy(zs, positions, n);
}

// Sorted MO energies in Hartree; returns the orbital count (clipped to
// max_out entries written). n_electrons_out receives the valence electron
// count (aufbau occupation: pairs from the bottom). For external-anchor
// tests (orbital degeneracies, HOMO levels, Walsh-diagram trends).
int mg_eht_orbitals(const int* zs, const double* positions, int n_atoms,
                    double* eps_out, int max_out, int* n_electrons_out) {
  std::vector<double> ew;
  double e_rep = 0.0;
  const int n = eht::solve_orbitals(zs, positions, n_atoms, ew,
                                    n_electrons_out, &e_rep);
  for (int i = 0; i < n && i < max_out; ++i) eps_out[i] = ew[i];
  return n;
}
}
