// McMurchie-Davidson two-electron repulsion integrals — native engine.
//
// Frozen copy of esoo_torch/native/mcmurchie.cpp (host C++, no device code),
// and the Python engine in integrals.py is the correctness
// oracle; this module computes the identical contracted cartesian ERI
// tensor (chemist (ab|cd) ordering, 8-fold permutational symmetry,
// threaded over bra shell pairs with OpenMP).
//
// Exposed C ABI (ctypes):
//   esoo_eri_cart(nshell, l[], centers[], nprim[], prim_off[],
//                 exps[], coefs[], out[], nbf_cart) -> 0 on success
//
// Conventions match integrals.py exactly:
//   * coefs are the shells' `cnorm` contraction weights (primitive norms of
//     the (l,0,0) component folded in),
//   * per-component normalization ratios (double-factorial ratios) are
//     recomputed here,
//   * cartesian components are ordered lx descending, then ly descending.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kPi = 3.14159265358979323846;

double double_factorial(int n) {
  double out = 1.0;
  while (n > 0) {
    out *= n;
    n -= 2;
  }
  return out;
}

// ---- Boys function F_n(T) for n = 0..n_max -------------------------------
void boys(int n_max, double T, double* F) {
  if (T < 1e-13) {
    for (int n = 0; n <= n_max; ++n) F[n] = 1.0 / (2 * n + 1);
    return;
  }
  if (T > 35.0) {
    // asymptotic F_0 + stable upward recursion
    F[0] = 0.5 * std::sqrt(kPi / T);
    const double expT = std::exp(-T);
    for (int n = 0; n < n_max; ++n)
      F[n + 1] = ((2 * n + 1) * F[n] - expT) / (2.0 * T);
    return;
  }
  // series for F_{n_max}: exp(-T) * sum_i (2T)^i / prod_{k=0..i}(2n+2k+1)
  const double expT = std::exp(-T);
  double term = 1.0 / (2 * n_max + 1);
  double sum = term;
  for (int i = 1; i < 200; ++i) {
    term *= 2.0 * T / (2 * n_max + 2 * i + 1);
    sum += term;
    if (term < 1e-17 * sum) break;
  }
  F[n_max] = expT * sum;
  for (int n = n_max - 1; n >= 0; --n)
    F[n] = (2.0 * T * F[n + 1] + expT) / (2 * n + 1);
}

// ---- Hermite expansion coefficients E[i][j][t] (one dimension) -----------
struct ETable {
  int la, lb;
  std::vector<double> data;  // (la+1) x (lb+1) x (la+lb+1)
  double& at(int i, int j, int t) {
    return data[(i * (lb + 1) + j) * (la + lb + 1) + t];
  }
  double at(int i, int j, int t) const {
    return data[(i * (lb + 1) + j) * (la + lb + 1) + t];
  }
};

ETable hermite_coefs(int la, int lb, double AB, double a, double b) {
  ETable E;
  E.la = la;
  E.lb = lb;
  E.data.assign((la + 1) * (lb + 1) * (la + lb + 1), 0.0);
  const double p = a + b;
  const double q = a * b / p;
  E.at(0, 0, 0) = std::exp(-q * AB * AB);
  for (int i = 0; i <= la; ++i) {
    for (int j = 0; j <= lb; ++j) {
      if (i == 0 && j == 0) continue;
      for (int t = 0; t <= i + j; ++t) {
        double v = 0.0;
        if (j == 0) {
          if (t - 1 >= 0) v += E.at(i - 1, j, t - 1) / (2.0 * p);
          v -= (q * AB / a) * E.at(i - 1, j, t);
          if (t + 1 <= i + j - 1) v += (t + 1) * E.at(i - 1, j, t + 1);
        } else {
          if (t - 1 >= 0) v += E.at(i, j - 1, t - 1) / (2.0 * p);
          v += (q * AB / b) * E.at(i, j - 1, t);
          if (t + 1 <= i + j - 1) v += (t + 1) * E.at(i, j - 1, t + 1);
        }
        E.at(i, j, t) = v;
      }
    }
  }
  return E;
}

// ---- Hermite Coulomb integrals R^0_{t,u,v} -------------------------------
struct RTable {
  int L;                      // max order per index
  std::vector<double> data;   // (L+1)^3
  double& at(int t, int u, int v) {
    return data[(t * (L + 1) + u) * (L + 1) + v];
  }
  double at(int t, int u, int v) const {
    return data[(t * (L + 1) + u) * (L + 1) + v];
  }
};

RTable hermite_coulomb(int L, double p, const double* PC) {
  const int nmax = 3 * L;
  std::vector<double> F(nmax + 1);
  const double T = p * (PC[0] * PC[0] + PC[1] * PC[1] + PC[2] * PC[2]);
  boys(nmax, T, F.data());

  // R[n][t][u][v] with downward recursion in n
  const int d = L + 1;
  std::vector<double> R((nmax + 1) * d * d * d, 0.0);
  auto idx = [d](int n, int t, int u, int v) {
    return ((n * d + t) * d + u) * d + v;
  };
  double m2p = 1.0;
  for (int n = 0; n <= nmax; ++n) {
    R[idx(n, 0, 0, 0)] = m2p * F[n];
    m2p *= -2.0 * p;
  }
  for (int total = 1; total <= 3 * L; ++total) {
    for (int t = 0; t <= std::min(total, L); ++t) {
      for (int u = 0; u <= std::min(total - t, L); ++u) {
        const int v = total - t - u;
        if (v < 0 || v > L) continue;
        for (int n = 0; n <= nmax - total; ++n) {
          double val;
          if (t > 0) {
            val = PC[0] * R[idx(n + 1, t - 1, u, v)];
            if (t > 1) val += (t - 1) * R[idx(n + 1, t - 2, u, v)];
          } else if (u > 0) {
            val = PC[1] * R[idx(n + 1, t, u - 1, v)];
            if (u > 1) val += (u - 1) * R[idx(n + 1, t, u - 2, v)];
          } else {
            val = PC[2] * R[idx(n + 1, t, u, v - 1)];
            if (v > 1) val += (v - 1) * R[idx(n + 1, t, u, v - 2)];
          }
          R[idx(n, t, u, v)] = val;
        }
      }
    }
  }
  RTable out;
  out.L = L;
  out.data.assign(d * d * d, 0.0);
  for (int t = 0; t <= L; ++t)
    for (int u = 0; u <= L; ++u)
      for (int v = 0; v <= L; ++v) out.at(t, u, v) = R[idx(0, t, u, v)];
  return out;
}

// ---- shell bookkeeping ----------------------------------------------------
struct Shell {
  int l;
  double center[3];
  const double* exps;
  const double* coefs;
  int nprim;
  int ncart() const { return (l + 1) * (l + 2) / 2; }
};

struct CartComp {
  int x, y, z;
};

std::vector<CartComp> cart_components(int l) {
  std::vector<CartComp> out;
  for (int lx = l; lx >= 0; --lx)
    for (int ly = l - lx; ly >= 0; --ly) out.push_back({lx, ly, l - lx - ly});
  return out;
}

std::vector<double> cart_norm_factors(int l) {
  auto comps = cart_components(l);
  auto df = [](const CartComp& c) {
    return std::sqrt(double_factorial(2 * c.x - 1) *
                     double_factorial(2 * c.y - 1) *
                     double_factorial(2 * c.z - 1));
  };
  const double ref = df(comps[0]);
  std::vector<double> out;
  out.reserve(comps.size());
  for (auto& c : comps) out.push_back(ref / df(c));
  return out;
}

// E3 tensor for one primitive pair: [ca][cb][t][u][v], f-scaled
struct PairPrim {
  double p;          // a + b
  double P[3];       // gaussian product center
  double cc;         // contraction weight product
  std::vector<double> E3;  // nca*ncb*(Lab+1)^3
};

std::vector<PairPrim> shell_pair_prims(const Shell& A, const Shell& B) {
  const int la = A.l, lb = B.l;
  const int Lab = la + lb;
  const int d = Lab + 1;
  auto ca = cart_components(la);
  auto cb = cart_components(lb);
  auto fa = cart_norm_factors(la);
  auto fb = cart_norm_factors(lb);
  const int nca = (int)ca.size(), ncb = (int)cb.size();

  std::vector<PairPrim> out;
  out.reserve(A.nprim * B.nprim);
  for (int ia = 0; ia < A.nprim; ++ia) {
    for (int ib = 0; ib < B.nprim; ++ib) {
      const double a = A.exps[ia], b = B.exps[ib];
      PairPrim pp;
      pp.p = a + b;
      for (int d3 = 0; d3 < 3; ++d3)
        pp.P[d3] = (a * A.center[d3] + b * B.center[d3]) / pp.p;
      pp.cc = A.coefs[ia] * B.coefs[ib];
      ETable Ex = hermite_coefs(la, lb, A.center[0] - B.center[0], a, b);
      ETable Ey = hermite_coefs(la, lb, A.center[1] - B.center[1], a, b);
      ETable Ez = hermite_coefs(la, lb, A.center[2] - B.center[2], a, b);
      pp.E3.assign((size_t)nca * ncb * d * d * d, 0.0);
      for (int i = 0; i < nca; ++i) {
        for (int j = 0; j < ncb; ++j) {
          const double f = fa[i] * fb[j];
          double* dst = &pp.E3[((size_t)i * ncb + j) * d * d * d];
          for (int t = 0; t <= ca[i].x + cb[j].x; ++t)
            for (int u = 0; u <= ca[i].y + cb[j].y; ++u)
              for (int v = 0; v <= ca[i].z + cb[j].z; ++v)
                dst[(t * d + u) * d + v] = f * Ex.at(ca[i].x, cb[j].x, t) *
                                           Ey.at(ca[i].y, cb[j].y, u) *
                                           Ez.at(ca[i].z, cb[j].z, v);
        }
      }
      out.push_back(std::move(pp));
    }
  }
  return out;
}

// contracted quartet block (ab|cd), cartesian components
void eri_block(const Shell& A, const Shell& B, const Shell& C, const Shell& D,
               const std::vector<PairPrim>& bra,
               const std::vector<PairPrim>& ket, double* out /*nca*ncb*ncc*ncd*/) {
  const int Lab = A.l + B.l, Lcd = C.l + D.l;
  const int dab = Lab + 1, dcd = Lcd + 1;
  const int nca = A.ncart(), ncb = B.ncart(), ncc = C.ncart(), ncd = D.ncart();
  const size_t nblk = (size_t)nca * ncb * ncc * ncd;
  std::memset(out, 0, nblk * sizeof(double));

  const int L = Lab + Lcd;
  std::vector<double> herm((size_t)dab * dab * dab * ncc * ncd);

  for (const auto& b : bra) {
    for (const auto& k : ket) {
      const double alpha = b.p * k.p / (b.p + k.p);
      const double pref =
          2.0 * std::pow(kPi, 2.5) / (b.p * k.p * std::sqrt(b.p + k.p));
      double PQ[3] = {b.P[0] - k.P[0], b.P[1] - k.P[1], b.P[2] - k.P[2]};
      RTable R = hermite_coulomb(L, alpha, PQ);

      // herm[t,u,v][c,d] = sum_{xyz} (-1)^{x+y+z} E3cd[c,d,x,y,z] R[t+x,u+y,v+z]
      std::fill(herm.begin(), herm.end(), 0.0);
      for (int c = 0; c < ncc; ++c) {
        for (int dd = 0; dd < ncd; ++dd) {
          const double* Ecd = &k.E3[((size_t)c * ncd + dd) * dcd * dcd * dcd];
          for (int x = 0; x < dcd; ++x)
            for (int y = 0; y < dcd; ++y)
              for (int z = 0; z < dcd; ++z) {
                const double e = Ecd[(x * dcd + y) * dcd + z];
                if (e == 0.0) continue;
                const double se = ((x + y + z) % 2) ? -e : e;
                for (int t = 0; t < dab; ++t)
                  for (int u = 0; u < dab; ++u)
                    for (int v = 0; v < dab; ++v)
                      herm[((((size_t)t * dab + u) * dab + v) * ncc + c) * ncd +
                           dd] += se * R.at(t + x, u + y, v + z);
              }
        }
      }
      // out[a,b,c,d] += cc * pref * sum_{tuv} E3ab[a,b,t,u,v] herm[t,u,v,c,d]
      const double w = b.cc * k.cc * pref;
      for (int a = 0; a < nca; ++a) {
        for (int bb = 0; bb < ncb; ++bb) {
          const double* Eab = &b.E3[((size_t)a * ncb + bb) * dab * dab * dab];
          double* dst = &out[((size_t)a * ncb + bb) * ncc * ncd];
          for (int t = 0; t < dab; ++t)
            for (int u = 0; u < dab; ++u)
              for (int v = 0; v < dab; ++v) {
                const double e = Eab[(t * dab + u) * dab + v];
                if (e == 0.0) continue;
                const double we = w * e;
                const double* h =
                    &herm[(((size_t)t * dab + u) * dab + v) * ncc * ncd];
                for (int cd = 0; cd < ncc * ncd; ++cd) dst[cd] += we * h[cd];
              }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Full contracted cartesian ERI tensor with 8-fold permutational symmetry.
int esoo_eri_cart(int nshell, const int* l, const double* centers,
                  const int* nprim, const int* prim_off, const double* exps,
                  const double* coefs, double* out, int nbf) {
  std::vector<Shell> shells(nshell);
  std::vector<int> offset(nshell);
  int n = 0;
  for (int i = 0; i < nshell; ++i) {
    shells[i].l = l[i];
    shells[i].center[0] = centers[3 * i];
    shells[i].center[1] = centers[3 * i + 1];
    shells[i].center[2] = centers[3 * i + 2];
    shells[i].nprim = nprim[i];
    shells[i].exps = exps + prim_off[i];
    shells[i].coefs = coefs + prim_off[i];
    offset[i] = n;
    n += shells[i].ncart();
  }
  if (n != nbf) return 1;

  // primitive-pair tables for every ordered shell pair (i >= j)
  std::vector<std::pair<int, int>> pairs;
  for (int i = 0; i < nshell; ++i)
    for (int j = 0; j <= i; ++j) pairs.emplace_back(i, j);
  const int npair = (int)pairs.size();
  std::vector<std::vector<PairPrim>> pair_prims(npair);
#pragma omp parallel for schedule(dynamic)
  for (int ij = 0; ij < npair; ++ij)
    pair_prims[ij] = shell_pair_prims(shells[pairs[ij].first],
                                      shells[pairs[ij].second]);

  const size_t N = (size_t)nbf;
#pragma omp parallel
  {
    std::vector<double> blk;
#pragma omp for schedule(dynamic)
    for (int ij = 0; ij < npair; ++ij) {
      const int i = pairs[ij].first, j = pairs[ij].second;
      for (int kl = 0; kl <= ij; ++kl) {
        const int k = pairs[kl].first, lq = pairs[kl].second;
        const Shell &A = shells[i], &B = shells[j], &C = shells[k],
                    &D = shells[lq];
        const int na = A.ncart(), nb = B.ncart(), nc = C.ncart(),
                  nd = D.ncart();
        blk.assign((size_t)na * nb * nc * nd, 0.0);
        eri_block(A, B, C, D, pair_prims[ij], pair_prims[kl], blk.data());

        const int oi = offset[i], oj = offset[j], ok = offset[k],
                  ol = offset[lq];
        for (int a = 0; a < na; ++a)
          for (int bq = 0; bq < nb; ++bq)
            for (int c = 0; c < nc; ++c)
              for (int d = 0; d < nd; ++d) {
                const double v =
                    blk[(((size_t)a * nb + bq) * nc + c) * nd + d];
                const size_t pa = oi + a, pb = oj + bq, pc = ok + c,
                             pd = ol + d;
                out[((pa * N + pb) * N + pc) * N + pd] = v;
                out[((pb * N + pa) * N + pc) * N + pd] = v;
                out[((pa * N + pb) * N + pd) * N + pc] = v;
                out[((pb * N + pa) * N + pd) * N + pc] = v;
                out[((pc * N + pd) * N + pa) * N + pb] = v;
                out[((pd * N + pc) * N + pa) * N + pb] = v;
                out[((pc * N + pd) * N + pb) * N + pa] = v;
                out[((pd * N + pc) * N + pb) * N + pa] = v;
              }
      }
    }
  }
  return 0;
}

}  // extern "C"
