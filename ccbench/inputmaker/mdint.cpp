// McMurchie-Davidson Gaussian integral engine — native C++/OpenMP core.
//
// Native counterpart of the reference's C integral drivers (libcint +
// pyscf/lib/ao2mo/nr_ao2mo.c): the host-side setup path producing AO
// integrals for the JAX/TPU correlation stack.  Clean-room implementation
// of the same algorithm as ../intor.py (Hermite E coefficients + Hermite
// Coulomb R recursion on Boys values): OpenMP over shell-pair blocks.
//
// Simplification contract with the Python caller:
//   * all shells are SEGMENTED (nctr == 1); general contractions are
//     expanded Python-side before calling in,
//   * cart2sph matrices are supplied by Python (generated + unit-tested
//     there); pass cart=1 to skip the spherical transform,
//   * outputs are dense float64 row-major arrays.
//
// Exposed C ABI (ctypes): md_eri4c, md_eri3c, md_eri2c, md_num_threads.

#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int ncart(int l) { return (l + 1) * (l + 2) / 2; }

// ---------------------------------------------------------------- Boys F_n
void boys(int nmax, double T, double* F) {
    if (T < 1e-13) {
        for (int n = 0; n <= nmax; ++n) F[n] = 1.0 / (2 * n + 1);
        return;
    }
    double Fm;
    if (T < 35.0) {
        double num = 1.0;
        double den = 2.0 * nmax + 1.0;
        double term = 1.0 / den;
        double sum = term;
        for (int i = 1; i < 300; ++i) {
            num *= 2.0 * T;
            den *= (2.0 * nmax + 2.0 * i + 1.0);
            term = num / den;
            sum += term;
            if (term < sum * 1e-17) break;
        }
        Fm = std::exp(-T) * sum;
    } else {
        double df = 1.0;
        for (int k = 1; k <= nmax; ++k) df *= (2 * k - 1);
        Fm = df / std::pow(2.0 * T, nmax) * 0.5 * std::sqrt(M_PI / T);
    }
    F[nmax] = Fm;
    double et = std::exp(-T);
    for (int n = nmax - 1; n >= 0; --n)
        F[n] = (2.0 * T * F[n + 1] + et) / (2 * n + 1);
}

// ------------------------------------------------- Hermite E coefficients
struct E1d {
    int la, lb;
    std::vector<double> v;  // (la+1)*(lb+1)*(la+lb+1)
    inline double get(int i, int j, int t) const {
        return v[(i * (lb + 1) + j) * (la + lb + 1) + t];
    }
    inline double& at(int i, int j, int t) {
        return v[(i * (lb + 1) + j) * (la + lb + 1) + t];
    }
};

void e_coeffs(int la, int lb, double a, double b, double AB, E1d& E) {
    E.la = la; E.lb = lb;
    E.v.assign((size_t)(la + 1) * (lb + 1) * (la + lb + 1), 0.0);
    double p = a + b;
    double mu = a * b / p;
    double inv2p = 0.5 / p;
    double pa = -b / p * AB;
    double pb = a / p * AB;
    E.at(0, 0, 0) = std::exp(-mu * AB * AB);
    for (int i = 1; i <= la; ++i)
        for (int t = 0; t <= i; ++t) {
            double x = pa * E.get(i - 1, 0, t);
            if (t > 0) x += inv2p * E.get(i - 1, 0, t - 1);
            if (t + 1 <= i - 1) x += (t + 1) * E.get(i - 1, 0, t + 1);
            E.at(i, 0, t) = x;
        }
    for (int j = 1; j <= lb; ++j)
        for (int i = 0; i <= la; ++i)
            for (int t = 0; t <= i + j; ++t) {
                double x = pb * E.get(i, j - 1, t);
                if (t > 0) x += inv2p * E.get(i, j - 1, t - 1);
                if (t + 1 <= i + j - 1) x += (t + 1) * E.get(i, j - 1, t + 1);
                E.at(i, j, t) = x;
            }
}

// ----------------------------------------------------- two-electron kernels
// Generalized interaction kernels f(r12) for the MD scheme.  The Hermite
// R recursion is unchanged; only the fundamental ladder F[m] (and the
// primitive-pair prefactor) depend on the kernel:
//   F[m] = (-d/dT)^m Theta0(T),  T = rho |P-Q|^2,  rho = pq/(p+q)
// Types: 0 Coulomb 1/r12 (Boys); 1 Gaussian geminal exp(-g r12^2),
// Theta0 = exp(-sT), s = g/(rho+g); 2 Gaussian-damped Coulomb
// exp(-g r12^2)/r12, Theta0 = exp(-sT) F0(bT), b = rho/(rho+g);
// 3 r12^2 exp(-g r12^2) = -d/dg of type 1 (per unit type-1 prefactor):
// Theta0 = exp(-sT) (3/(2(rho+g)) + T rho/(rho+g)^2).
// Slater-type geminals (F12) enter as fitted sums of these kernels.
struct Kern {
    int type;
    double gamma;
};

void kern_fvals(const Kern& k, int nmax, double rho, double T, double* F) {
    if (k.type == 0) {
        boys(nmax, T, F);
        return;
    }
    double s = k.gamma / (rho + k.gamma);
    if (k.type == 1) {
        double e = std::exp(-s * T);
        double f = 1.0;
        for (int m = 0; m <= nmax; ++m) {
            F[m] = f * e;
            f *= s;
        }
        return;
    }
    if (k.type == 3) {
        // Theta0 = e^{-sT} (A + B T); (-d/dT)^m: product rule on the
        // linear-in-T factor
        double rg = rho + k.gamma;
        double A = 1.5 / rg;
        double Bc = rho / (rg * rg);
        double e = std::exp(-s * T);
        double sm = 1.0;                       // s^m
        for (int m = 0; m <= nmax; ++m) {
            double smm1 = (m == 0) ? 0.0 : std::pow(s, m - 1);
            F[m] = e * (sm * (A + Bc * T) - m * smm1 * Bc);
            sm *= s;
        }
        return;
    }
    double b = rho / (rho + k.gamma);
    double Fb[64];
    boys(nmax, b * T, Fb);
    double e = std::exp(-s * T);
    for (int m = 0; m <= nmax; ++m) {
        double acc = 0.0;
        double C = 1.0;                       // binomial C(m, kk)
        for (int kk = 0; kk <= m; ++kk) {
            acc += C * std::pow(s, m - kk) * std::pow(b, kk) * Fb[kk];
            C = C * (m - kk) / (kk + 1.0);
        }
        F[m] = acc * e;
    }
}

double kern_pref(const Kern& k, double p, double q) {
    if (k.type == 0)
        return 2.0 * std::pow(M_PI, 2.5) / (p * q * std::sqrt(p + q));
    double rho = p * q / (p + q);
    if (k.type == 1 || k.type == 3)
        return std::pow(M_PI, 3.0)
               / std::pow((p + q) * (rho + k.gamma), 1.5);
    return 2.0 * std::pow(M_PI, 2.5)
           / (std::pow(p + q, 1.5) * (rho + k.gamma));
}

// --------------------------------------------- Hermite Coulomb R recursion
// Computes R_{tuv} (n=0 level) for all t+u+v <= L into a (L+1)^3 box.
void r_tensor(int L, double alpha, double X, double Y, double Z,
              std::vector<double>& out, std::vector<double>& scratch,
              const Kern& kern = Kern{0, 0.0}) {
    double T = alpha * (X * X + Y * Y + Z * Z);
    double F[64];
    kern_fvals(kern, L, alpha, T, F);
    int n1 = L + 1;
    size_t box = (size_t)n1 * n1 * n1;
    // lev[m] boxes flattened into scratch
    scratch.assign(box * (L + 1), 0.0);
    auto idx = [n1](int t, int u, int v) {
        return ((size_t)t * n1 + u) * n1 + v;
    };
    double fac = 1.0;
    for (int m = 0; m <= L; ++m) {
        scratch[box * m] = fac * F[m];
        fac *= -2.0 * alpha;
    }
    for (int total = 1; total <= L; ++total)
        for (int t = 0; t <= total; ++t)
            for (int u = 0; u <= total - t; ++u) {
                int v = total - t - u;
                size_t o = idx(t, u, v);
                for (int m = 0; m + total <= L; ++m) {
                    double* lm = &scratch[box * m];
                    const double* l1 = &scratch[box * (m + 1)];
                    double val;
                    if (t > 0) {
                        val = X * l1[idx(t - 1, u, v)];
                        if (t > 1) val += (t - 1) * l1[idx(t - 2, u, v)];
                    } else if (u > 0) {
                        val = Y * l1[idx(t, u - 1, v)];
                        if (u > 1) val += (u - 1) * l1[idx(t, u - 2, v)];
                    } else {
                        val = Z * l1[idx(t, u, v - 1)];
                        if (v > 1) val += (v - 1) * l1[idx(t, u, v - 2)];
                    }
                    lm[o] = val;
                }
            }
    out.assign(scratch.begin(), scratch.begin() + box);
}

// ------------------------------------------------------------ shell table
struct Shells {
    const int* l;
    const int* nprim;
    const int* prim_off;   // into exps / coefs
    const double* exps;
    const double* coefs;   // one coefficient per primitive (segmented)
    const double* centers; // 3*nsh
    const int* ao_off;     // per-shell AO offset (+ final = nao)
    int nsh;
};

struct C2S {
    const double* data;
    const long* off;   // per-l offsets into data
    int cart;
};

// Contracted Hermite representation of a segmented shell pair.
struct PairData {
    int la, lb, cab, nprim, L, n1;
    std::vector<double> E;    // [cab][ (L+1)^3 ][nprim], coefs folded
    std::vector<double> P;    // [nprim][3]
    std::vector<double> p;    // [nprim]
    int i0a, i0b;             // AO offsets
};

void build_pair(const Shells& sh, int ish, int jsh, PairData& pd) {
    int la = sh.l[ish], lb = sh.l[jsh];
    int npa = sh.nprim[ish], npb = sh.nprim[jsh];
    const double* A = sh.centers + 3 * ish;
    const double* B = sh.centers + 3 * jsh;
    pd.la = la; pd.lb = lb;
    pd.cab = ncart(la) * ncart(lb);
    pd.nprim = npa * npb;
    pd.L = la + lb;
    pd.n1 = pd.L + 1;
    size_t nherm = (size_t)pd.n1 * pd.n1 * pd.n1;
    pd.E.assign((size_t)pd.cab * nherm * pd.nprim, 0.0);
    pd.P.assign((size_t)pd.nprim * 3, 0.0);
    pd.p.assign(pd.nprim, 0.0);
    pd.i0a = sh.ao_off[ish];
    pd.i0b = sh.ao_off[jsh];

    E1d Ex, Ey, Ez;
    int ip = 0;
    for (int i = 0; i < npa; ++i) {
        double a = sh.exps[sh.prim_off[ish] + i];
        double ca = sh.coefs[sh.prim_off[ish] + i];
        for (int j = 0; j < npb; ++j, ++ip) {
            double b = sh.exps[sh.prim_off[jsh] + j];
            double w = ca * sh.coefs[sh.prim_off[jsh] + j];
            double psum = a + b;
            pd.p[ip] = psum;
            for (int d = 0; d < 3; ++d)
                pd.P[ip * 3 + d] = (a * A[d] + b * B[d]) / psum;
            e_coeffs(la, lb, a, b, A[0] - B[0], Ex);
            e_coeffs(la, lb, a, b, A[1] - B[1], Ey);
            e_coeffs(la, lb, a, b, A[2] - B[2], Ez);
            int ca_i = 0;
            for (int ix = la; ix >= 0; --ix)
                for (int iy = la - ix; iy >= 0; --iy, ++ca_i) {
                    int iz = la - ix - iy;
                    int cb_i = 0;
                    for (int jx = lb; jx >= 0; --jx)
                        for (int jy = lb - jx; jy >= 0; --jy, ++cb_i) {
                            int jz = lb - jx - jy;
                            size_t base = ((size_t)(ca_i * ncart(lb) + cb_i))
                                          * nherm * pd.nprim;
                            for (int t = 0; t <= ix + jx; ++t)
                                for (int u = 0; u <= iy + jy; ++u)
                                    for (int v = 0; v <= iz + jz; ++v) {
                                        double e = w * Ex.get(ix, jx, t)
                                                     * Ey.get(iy, jy, u)
                                                     * Ez.get(iz, jz, v);
                                        size_t h = ((size_t)t * pd.n1 + u)
                                                   * pd.n1 + v;
                                        pd.E[base + h * pd.nprim + ip] = e;
                                    }
                        }
                }
        }
    }
}

// Coulomb contraction of two pair distributions -> cart block [cab][ccd].
void coulomb_block(const PairData& pa, const PairData& pb,
                   std::vector<double>& out,
                   std::vector<double>& mid,
                   std::vector<double>& rbox, std::vector<double>& rscr,
                   const Kern& kern = Kern{0, 0.0}) {
    int L = pa.L + pb.L;
    int n1 = L + 1;
    size_t nherm_a = (size_t)pa.n1 * pa.n1 * pa.n1;
    size_t nherm_b = (size_t)pb.n1 * pb.n1 * pb.n1;
    out.assign((size_t)pa.cab * pb.cab, 0.0);
    for (int ip = 0; ip < pa.nprim; ++ip) {
        double p = pa.p[ip];
        mid.assign(nherm_a * pb.cab, 0.0);
        bool any = false;
        for (int jp = 0; jp < pb.nprim; ++jp) {
            double q = pb.p[jp];
            double alpha = p * q / (p + q);
            double pref = kern_pref(kern, p, q);
            double X = pa.P[ip * 3 + 0] - pb.P[jp * 3 + 0];
            double Y = pa.P[ip * 3 + 1] - pb.P[jp * 3 + 1];
            double Z = pa.P[ip * 3 + 2] - pb.P[jp * 3 + 2];
            r_tensor(L, alpha, X, Y, Z, rbox, rscr, kern);
            any = true;
            for (int xc = 0; xc < pb.cab; ++xc) {
                size_t ebase = (size_t)xc * nherm_b * pb.nprim;
                for (int tb = 0; tb <= pb.L; ++tb)
                    for (int ub = 0; ub <= pb.L - tb; ++ub)
                        for (int vb = 0; vb <= pb.L - tb - ub; ++vb) {
                            size_t hk = ((size_t)tb * pb.n1 + ub) * pb.n1 + vb;
                            double ek = pb.E[ebase + hk * pb.nprim + jp];
                            if (ek == 0.0) continue;
                            double w = ((tb + ub + vb) & 1) ? -ek * pref
                                                            : ek * pref;
                            for (int t = 0; t <= pa.L; ++t)
                                for (int u = 0; u <= pa.L - t; ++u)
                                    for (int v = 0; v <= pa.L - t - u; ++v) {
                                        size_t hb = ((size_t)t * pa.n1 + u)
                                                    * pa.n1 + v;
                                        double r = rbox[((size_t)(t + tb) * n1
                                                   + (u + ub)) * n1 + (v + vb)];
                                        mid[hb * pb.cab + xc] += w * r;
                                    }
                        }
            }
        }
        if (!any) continue;
        for (int xab = 0; xab < pa.cab; ++xab) {
            size_t ebase = (size_t)xab * nherm_a * pa.nprim;
            double* o = &out[(size_t)xab * pb.cab];
            for (int t = 0; t <= pa.L; ++t)
                for (int u = 0; u <= pa.L - t; ++u)
                    for (int v = 0; v <= pa.L - t - u; ++v) {
                        size_t hb = ((size_t)t * pa.n1 + u) * pa.n1 + v;
                        double eb = pa.E[ebase + hb * pa.nprim + ip];
                        if (eb == 0.0) continue;
                        const double* m = &mid[hb * pb.cab];
                        for (int xc = 0; xc < pb.cab; ++xc)
                            o[xc] += eb * m[xc];
                    }
        }
    }
}

// Schwarz bound of a shell pair: sqrt(max_ab (ab|ab)) over the pair's
// contracted cartesian components, for the given kernel.  Cauchy-Schwarz
// |(ab|cd)| <= Q_ab Q_cd holds for any positive-definite interaction
// (Coulomb, Gaussian geminal, damped Coulomb).
double schwarz_q(const PairData& pd, std::vector<double>& blk,
                 std::vector<double>& mid, std::vector<double>& rbox,
                 std::vector<double>& rscr, const Kern& kern = Kern{0, 0.0}) {
    coulomb_block(pd, pd, blk, mid, rbox, rscr, kern);
    double q = 0.0;
    for (int x = 0; x < pd.cab; ++x) {
        double d = std::fabs(blk[(size_t)x * pd.cab + x]);
        if (d > q) q = d;
    }
    return std::sqrt(q);
}

// sph transform on the bra pair of a [cab][ncol] block:
// [ca][cb][ncol] -> [sa][sb][ncol]
void sph_bra(const double* blk, int la, int lb, int ncol, const C2S& c2s,
             std::vector<double>& out, std::vector<double>& tmp) {
    int na_c = ncart(la), nb_c = ncart(lb);
    if (c2s.cart) {
        out.assign(blk, blk + (size_t)na_c * nb_c * ncol);
        return;
    }
    int nsa = 2 * la + 1, nsb = 2 * lb + 1;
    const double* Ca = c2s.data + c2s.off[la];
    const double* Cb = c2s.data + c2s.off[lb];
    tmp.assign((size_t)nsa * nb_c * ncol, 0.0);
    for (int ma = 0; ma < nsa; ++ma)
        for (int xa = 0; xa < na_c; ++xa) {
            double c = Ca[ma * na_c + xa];
            if (c == 0.0) continue;
            const double* src = blk + (size_t)xa * nb_c * ncol;
            double* dst = &tmp[(size_t)ma * nb_c * ncol];
            for (size_t k = 0; k < (size_t)nb_c * ncol; ++k)
                dst[k] += c * src[k];
        }
    out.assign((size_t)nsa * nsb * ncol, 0.0);
    for (int ma = 0; ma < nsa; ++ma)
        for (int mb = 0; mb < nsb; ++mb) {
            double* dst = &out[((size_t)ma * nsb + mb) * ncol];
            for (int xb = 0; xb < nb_c; ++xb) {
                double c = Cb[mb * nb_c + xb];
                if (c == 0.0) continue;
                const double* src = &tmp[((size_t)ma * nb_c + xb) * ncol];
                for (int k = 0; k < ncol; ++k)
                    dst[k] += c * src[k];
            }
        }
}

int nsph(int l, int cart) { return cart ? ncart(l) : 2 * l + 1; }

}  // namespace

extern "C" {

int md_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

// 3-center (mu nu | P): out shape (nao, nao, naux) row-major.
void md_eri3c(const int* l, const int* nprim, const int* prim_off,
              const double* exps, const double* coefs, const double* centers,
              const int* ao_off, int nsh,
              const int* l_x, const int* nprim_x, const int* prim_off_x,
              const double* exps_x, const double* coefs_x,
              const double* centers_x, const int* ao_off_x, int nsh_x,
              const double* c2s_data, const long* c2s_off, int cart,
              int nao, int naux, double* out) {
    Shells sh{l, nprim, prim_off, exps, coefs, centers, ao_off, nsh};
    Shells sx{l_x, nprim_x, prim_off_x, exps_x, coefs_x, centers_x,
              ao_off_x, nsh_x};
    C2S c2s{c2s_data, c2s_off, cart};
    const double screen = 1e-14;   // Schwarz threshold on |(mu nu|P)|
    // single-aux-shell Hermite data (shared by screening + main loop)
    auto build_aux = [&](int k, PairData& px) {
        px.la = sx.l[k]; px.lb = 0;
        px.cab = ncart(px.la);
        px.nprim = sx.nprim[k];
        px.L = px.la;
        px.n1 = px.L + 1;
        size_t nherm = (size_t)px.n1 * px.n1 * px.n1;
        px.E.assign((size_t)px.cab * nherm * px.nprim, 0.0);
        px.P.assign((size_t)px.nprim * 3, 0.0);
        px.p.assign(px.nprim, 0.0);
        const double* C = centers_x + 3 * k;
        E1d Ex;
        for (int ip = 0; ip < px.nprim; ++ip) {
            double a = exps_x[prim_off_x[k] + ip];
            double w = coefs_x[prim_off_x[k] + ip];
            px.p[ip] = a;
            px.P[ip * 3 + 0] = C[0];
            px.P[ip * 3 + 1] = C[1];
            px.P[ip * 3 + 2] = C[2];
            e_coeffs(px.la, 0, a, 0.0, 0.0, Ex);
            int ci = 0;
            for (int ix = px.la; ix >= 0; --ix)
                for (int iy = px.la - ix; iy >= 0; --iy, ++ci) {
                    int iz = px.la - ix - iy;
                    size_t base = (size_t)ci * nherm * px.nprim;
                    for (int tt = 0; tt <= ix; ++tt)
                        for (int uu = 0; uu <= iy; ++uu)
                            for (int vv = 0; vv <= iz; ++vv) {
                                double e = w * Ex.get(ix, 0, tt)
                                             * Ex.get(iy, 0, uu)
                                             * Ex.get(iz, 0, vv);
                                size_t h = ((size_t)tt * px.n1 + uu)
                                           * px.n1 + vv;
                                px.E[base + h * px.nprim + ip] = e;
                            }
                }
        }
    };
    // max aux Schwarz bound (for bra-pair screening)
    double qx_max = 0.0;
    {
        PairData px;
        std::vector<double> b_, m_, r_, s_;
        for (int k = 0; k < nsh_x; ++k) {
            build_aux(k, px);
            double q = schwarz_q(px, b_, m_, r_, s_);
            if (q > qx_max) qx_max = q;
        }
    }
    // list of bra shell pairs (i >= j)
    std::vector<std::pair<int, int>> pairs;
    for (int i = 0; i < nsh; ++i)
        for (int j = 0; j <= i; ++j)
            pairs.emplace_back(i, j);
    long np = (long)pairs.size();
#pragma omp parallel
    {
        PairData pd, px;
        std::vector<double> blk, mid, rbox, rscr, sp1, sp2, tmp;
#pragma omp for schedule(dynamic)
        for (long t = 0; t < np; ++t) {
            int i = pairs[t].first, j = pairs[t].second;
            build_pair(sh, i, j, pd);
            if (schwarz_q(pd, blk, mid, rbox, rscr) * qx_max < screen)
                continue;   // whole strip negligible; out stays zero
            int nsa = nsph(pd.la, cart), nsb = nsph(pd.lb, cart);
            // accumulate all aux shells into a [nsa][nsb][naux] strip
            std::vector<double> strip((size_t)nsa * nsb * naux, 0.0);
            for (int k = 0; k < nsh_x; ++k) {
                build_aux(k, px);
                coulomb_block(pd, px, blk, mid, rbox, rscr);
                // blk: [cab][cart_aux]; sph-transform the aux index first
                int nsc = nsph(px.la, cart);
                // transform aux (single index): out[cab][nsc]
                sp1.assign((size_t)pd.cab * nsc, 0.0);
                if (cart) {
                    sp1.assign(blk.begin(), blk.end());
                } else {
                    const double* Cc = c2s_data + c2s_off[px.la];
                    for (int xab = 0; xab < pd.cab; ++xab)
                        for (int mc = 0; mc < nsc; ++mc) {
                            double s = 0;
                            for (int xc = 0; xc < px.cab; ++xc)
                                s += Cc[mc * px.cab + xc]
                                   * blk[(size_t)xab * px.cab + xc];
                            sp1[(size_t)xab * nsc + mc] = s;
                        }
                }
                // transform bra pair: [cab][nsc] -> [nsa*nsb][nsc]
                sph_bra(sp1.data(), pd.la, pd.lb, nsc, c2s, sp2, tmp);
                int k0 = ao_off_x[k];
                for (int ma = 0; ma < nsa; ++ma)
                    for (int mb = 0; mb < nsb; ++mb)
                        for (int mc = 0; mc < nsc; ++mc)
                            strip[((size_t)ma * nsb + mb) * naux + k0 + mc] =
                                sp2[((size_t)ma * nsb + mb) * nsc + mc];
            }
            // scatter strip into out (both (i,j) and (j,i))
            int i0 = ao_off[i], j0 = ao_off[j];
            for (int ma = 0; ma < nsa; ++ma)
                for (int mb = 0; mb < nsb; ++mb) {
                    const double* src = &strip[((size_t)ma * nsb + mb) * naux];
                    std::memcpy(out + ((size_t)(i0 + ma) * nao + (j0 + mb))
                                * naux, src, sizeof(double) * naux);
                    if (i != j)
                        std::memcpy(out + ((size_t)(j0 + mb) * nao + (i0 + ma))
                                    * naux, src, sizeof(double) * naux);
                }
        }
    }
}

// 2-center (P|Q): out shape (naux, naux).
void md_eri2c(const int* l_x, const int* nprim_x, const int* prim_off_x,
              const double* exps_x, const double* coefs_x,
              const double* centers_x, const int* ao_off_x, int nsh_x,
              const double* c2s_data, const long* c2s_off, int cart,
              int naux, double* out) {
    // reuse md_eri3c machinery conceptually: build single-shell pair data
    C2S c2s{c2s_data, c2s_off, cart};
#pragma omp parallel
    {
        std::vector<double> blk, mid, rbox, rscr;
        E1d Ex;
#pragma omp for schedule(dynamic)
        for (int i = 0; i < nsh_x; ++i) {
            PairData pi, pj;
            auto build_single = [&](int k, PairData& px) {
                px.la = l_x[k]; px.lb = 0;
                px.cab = ncart(px.la);
                px.nprim = nprim_x[k];
                px.L = px.la;
                px.n1 = px.L + 1;
                size_t nherm = (size_t)px.n1 * px.n1 * px.n1;
                px.E.assign((size_t)px.cab * nherm * px.nprim, 0.0);
                px.P.assign((size_t)px.nprim * 3, 0.0);
                px.p.assign(px.nprim, 0.0);
                const double* C = centers_x + 3 * k;
                for (int ip = 0; ip < px.nprim; ++ip) {
                    double a = exps_x[prim_off_x[k] + ip];
                    double w = coefs_x[prim_off_x[k] + ip];
                    px.p[ip] = a;
                    for (int d = 0; d < 3; ++d) px.P[ip * 3 + d] = C[d];
                    e_coeffs(px.la, 0, a, 0.0, 0.0, Ex);
                    int ci = 0;
                    for (int ix = px.la; ix >= 0; --ix)
                        for (int iy = px.la - ix; iy >= 0; --iy, ++ci) {
                            int iz = px.la - ix - iy;
                            size_t base = (size_t)ci * nherm * px.nprim;
                            for (int tt = 0; tt <= ix; ++tt)
                                for (int uu = 0; uu <= iy; ++uu)
                                    for (int vv = 0; vv <= iz; ++vv) {
                                        double e = w * Ex.get(ix, 0, tt)
                                                     * Ex.get(iy, 0, uu)
                                                     * Ex.get(iz, 0, vv);
                                        size_t h = ((size_t)tt * px.n1 + uu)
                                                   * px.n1 + vv;
                                        px.E[base + h * px.nprim + ip] = e;
                                    }
                        }
                }
            };
            build_single(i, pi);
            for (int j = 0; j <= i; ++j) {
                build_single(j, pj);
                coulomb_block(pi, pj, blk, mid, rbox, rscr);
                int nsa = nsph(pi.la, cart), nsb = nsph(pj.la, cart);
                std::vector<double> sp((size_t)nsa * nsb, 0.0);
                if (cart) {
                    sp.assign(blk.begin(), blk.end());
                } else {
                    const double* Ca = c2s_data + c2s_off[pi.la];
                    const double* Cb = c2s_data + c2s_off[pj.la];
                    std::vector<double> t1v((size_t)nsa * pj.cab, 0.0);
                    for (int ma = 0; ma < nsa; ++ma)
                        for (int xa = 0; xa < pi.cab; ++xa) {
                            double c = Ca[ma * pi.cab + xa];
                            if (c == 0.0) continue;
                            for (int xb = 0; xb < pj.cab; ++xb)
                                t1v[(size_t)ma * pj.cab + xb] +=
                                    c * blk[(size_t)xa * pj.cab + xb];
                        }
                    for (int ma = 0; ma < nsa; ++ma)
                        for (int mb = 0; mb < nsb; ++mb) {
                            double s = 0;
                            for (int xb = 0; xb < pj.cab; ++xb)
                                s += Cb[mb * pj.cab + xb]
                                   * t1v[(size_t)ma * pj.cab + xb];
                            sp[(size_t)ma * nsb + mb] = s;
                        }
                }
                int i0 = ao_off_x[i], j0 = ao_off_x[j];
                for (int ma = 0; ma < nsa; ++ma)
                    for (int mb = 0; mb < nsb; ++mb) {
                        out[(size_t)(i0 + ma) * naux + j0 + mb] =
                            sp[(size_t)ma * nsb + mb];
                        out[(size_t)(j0 + mb) * naux + i0 + ma] =
                            sp[(size_t)ma * nsb + mb];
                    }
            }
        }
    }
}

// full 4-center (ij|kl): out shape (nao,nao,nao,nao).
void md_eri4c_kern(const int* l, const int* nprim, const int* prim_off,
                   const double* exps, const double* coefs,
                   const double* centers, const int* ao_off, int nsh,
                   const double* c2s_data, const long* c2s_off, int cart,
                   int nao, int kern_type, double kern_gamma,
                   double screen, double* out) {
    Kern kern{kern_type, kern_gamma};
    Shells sh{l, nprim, prim_off, exps, coefs, centers, ao_off, nsh};
    C2S c2s{c2s_data, c2s_off, cart};
    std::vector<std::pair<int, int>> pairs;
    for (int i = 0; i < nsh; ++i)
        for (int j = 0; j <= i; ++j)
            pairs.emplace_back(i, j);
    long np = (long)pairs.size();
    // precompute pair data + Schwarz bounds
    std::vector<PairData> pds(np);
    std::vector<double> qs(np, 0.0);
#pragma omp parallel
    {
        std::vector<double> b_, m_, r_, s_;
#pragma omp for schedule(dynamic)
        for (long t = 0; t < np; ++t) {
            build_pair(sh, pairs[t].first, pairs[t].second, pds[t]);
            if (screen > 0.0)
                qs[t] = schwarz_q(pds[t], b_, m_, r_, s_, kern);
        }
    }

#pragma omp parallel
    {
        std::vector<double> blk, mid, rbox, rscr, sp1, sp2, tmp, tmp2;
#pragma omp for schedule(dynamic)
        for (long t1i = 0; t1i < np; ++t1i) {
            for (long t2i = 0; t2i <= t1i; ++t2i) {
                if (screen > 0.0 && qs[t1i] * qs[t2i] < screen)
                    continue;
                const PairData& pa = pds[t1i];
                const PairData& pb = pds[t2i];
                coulomb_block(pa, pb, blk, mid, rbox, rscr, kern);
                // blk: [cab][ccd] -> sph both sides
                int nsa = nsph(pa.la, cart), nsb = nsph(pa.lb, cart);
                int nsc = nsph(pb.la, cart), nsd = nsph(pb.lb, cart);
                // transform ket pair: treat blk as [cab rows][ccd cols];
                // transpose to [ccd][cab], sph_bra on (lc,ld), transpose back
                int cab = pa.cab, ccd = pb.cab;
                tmp2.assign((size_t)ccd * cab, 0.0);
                for (int x = 0; x < cab; ++x)
                    for (int y = 0; y < ccd; ++y)
                        tmp2[(size_t)y * cab + x] = blk[(size_t)x * ccd + y];
                sph_bra(tmp2.data(), pb.la, pb.lb, cab, c2s, sp1, tmp);
                int nscd = nsc * nsd;
                // sp1: [nscd][cab] -> transpose -> [cab][nscd]
                tmp2.assign((size_t)cab * nscd, 0.0);
                for (int y = 0; y < nscd; ++y)
                    for (int x = 0; x < cab; ++x)
                        tmp2[(size_t)x * nscd + y] = sp1[(size_t)y * cab + x];
                sph_bra(tmp2.data(), pa.la, pa.lb, nscd, c2s, sp2, tmp);
                // sp2: [nsa*nsb][nscd]
                int i0 = pa.i0a, j0 = pa.i0b, k0 = pb.i0a, l0 = pb.i0b;
                for (int ma = 0; ma < nsa; ++ma)
                    for (int mb = 0; mb < nsb; ++mb)
                        for (int mc = 0; mc < nsc; ++mc)
                            for (int md = 0; md < nsd; ++md) {
                                double v = sp2[((size_t)ma * nsb + mb) * nscd
                                               + mc * nsd + md];
                                size_t I = i0 + ma, J = j0 + mb,
                                       K = k0 + mc, Lx = l0 + md;
                                size_t n = nao;
                                out[((I * n + J) * n + K) * n + Lx] = v;
                                out[((J * n + I) * n + K) * n + Lx] = v;
                                out[((I * n + J) * n + Lx) * n + K] = v;
                                out[((J * n + I) * n + Lx) * n + K] = v;
                                out[((K * n + Lx) * n + I) * n + J] = v;
                                out[((Lx * n + K) * n + I) * n + J] = v;
                                out[((K * n + Lx) * n + J) * n + I] = v;
                                out[((Lx * n + K) * n + J) * n + I] = v;
                            }
            }
        }
    }
}

void md_eri4c(const int* l, const int* nprim, const int* prim_off,
              const double* exps, const double* coefs, const double* centers,
              const int* ao_off, int nsh,
              const double* c2s_data, const long* c2s_off, int cart,
              int nao, double* out) {
    md_eri4c_kern(l, nprim, prim_off, exps, coefs, centers, ao_off, nsh,
                  c2s_data, c2s_off, cart, nao, 0, 0.0, 1e-14, out);
}

}  // extern "C"

// ===================================================== one-electron ints
namespace {

struct E1dFull {
    int la, lb;
    std::vector<double> v;
    inline double get(int i, int j, int t) const {
        return v[(i * (lb + 1) + j) * (la + lb + 1) + t];
    }
};

void e_coeffs_full(int la, int lb, double a, double b, double AB, E1dFull& E) {
    E1d tmp;
    e_coeffs(la, lb, a, b, AB, tmp);
    E.la = la; E.lb = lb;
    E.v = tmp.v;
}

}  // namespace

extern "C" {

// overlap + kinetic in one pass: out_s/out_t shape (nao, nao)
void md_ovlp_kin(const int* l, const int* nprim, const int* prim_off,
                 const double* exps, const double* coefs,
                 const double* centers, const int* ao_off, int nsh,
                 const double* c2s_data, const long* c2s_off, int cart,
                 int nao, double* out_s, double* out_t) {
    C2S c2s{c2s_data, c2s_off, cart};
#pragma omp parallel
    {
        std::vector<double> blk_s, blk_t, sp, tmp;
#pragma omp for schedule(dynamic)
        for (int i = 0; i < nsh; ++i) {
            for (int j = 0; j <= i; ++j) {
                int la = l[i], lb = l[j];
                int nca = ncart(la), ncb = ncart(lb);
                blk_s.assign((size_t)nca * ncb, 0.0);
                blk_t.assign((size_t)nca * ncb, 0.0);
                const double* A = centers + 3 * i;
                const double* B = centers + 3 * j;
                for (int ip = 0; ip < nprim[i]; ++ip) {
                    double a = exps[prim_off[i] + ip];
                    double ca = coefs[prim_off[i] + ip];
                    for (int jp = 0; jp < nprim[j]; ++jp) {
                        double b = exps[prim_off[j] + jp];
                        double w = ca * coefs[prim_off[j] + jp];
                        double p = a + b;
                        double pref = w * std::pow(M_PI / p, 1.5);
                        E1d Ex, Ey, Ez;
                        e_coeffs(la, lb + 2, a, b, A[0] - B[0], Ex);
                        e_coeffs(la, lb + 2, a, b, A[1] - B[1], Ey);
                        e_coeffs(la, lb + 2, a, b, A[2] - B[2], Ez);
                        auto s1 = [&](const E1d& E, int li, int lj) {
                            return (lj < 0) ? 0.0 : E.get(li, lj, 0);
                        };
                        auto k1 = [&](const E1d& E, int li, int lj) {
                            double t = -2.0 * b * b * s1(E, li, lj + 2)
                                     + b * (2 * lj + 1) * s1(E, li, lj);
                            if (lj >= 2) t -= 0.5 * lj * (lj - 1) * s1(E, li, lj - 2);
                            return t;
                        };
                        int ca_i = 0;
                        for (int ix = la; ix >= 0; --ix)
                        for (int iy = la - ix; iy >= 0; --iy, ++ca_i) {
                            int iz = la - ix - iy;
                            int cb_i = 0;
                            for (int jx = lb; jx >= 0; --jx)
                            for (int jy = lb - jx; jy >= 0; --jy, ++cb_i) {
                                int jz = lb - jx - jy;
                                double sx = s1(Ex, ix, jx), sy = s1(Ey, iy, jy),
                                       sz = s1(Ez, iz, jz);
                                blk_s[(size_t)ca_i * ncb + cb_i] += pref * sx * sy * sz;
                                double kx = k1(Ex, ix, jx), ky = k1(Ey, iy, jy),
                                       kz = k1(Ez, iz, jz);
                                blk_t[(size_t)ca_i * ncb + cb_i]
                                    += pref * (kx * sy * sz + sx * ky * sz
                                               + sx * sy * kz);
                            }
                        }
                    }
                }
                int nsa = nsph(la, cart), nsb = nsph(lb, cart);
                for (int which = 0; which < 2; ++which) {
                    const std::vector<double>& blk = which ? blk_t : blk_s;
                    double* out = which ? out_t : out_s;
                    sph_bra(blk.data(), la, lb, 1, c2s, sp, tmp);
                    int i0 = ao_off[i], j0 = ao_off[j];
                    for (int ma = 0; ma < nsa; ++ma)
                        for (int mb = 0; mb < nsb; ++mb) {
                            double v = sp[(size_t)ma * nsb + mb];
                            out[(size_t)(i0 + ma) * nao + j0 + mb] = v;
                            out[(size_t)(j0 + mb) * nao + i0 + ma] = v;
                        }
                }
            }
        }
    }
}

// nuclear attraction: out shape (nao, nao)
void md_nuc(const int* l, const int* nprim, const int* prim_off,
            const double* exps, const double* coefs, const double* centers,
            const int* ao_off, int nsh,
            const double* atm_coords, const double* atm_charges, int natm,
            const double* c2s_data, const long* c2s_off, int cart,
            int nao, double* out) {
    C2S c2s{c2s_data, c2s_off, cart};
#pragma omp parallel
    {
        std::vector<double> blk, sp, tmp, rbox, rscr;
#pragma omp for schedule(dynamic)
        for (int i = 0; i < nsh; ++i) {
            PairData pd;
            Shells sh{l, nprim, prim_off, exps, coefs, centers, ao_off, nsh};
            for (int j = 0; j <= i; ++j) {
                build_pair(sh, i, j, pd);
                int la = l[i], lb = l[j];
                int nca = ncart(la), ncb = ncart(lb);
                size_t nherm = (size_t)pd.n1 * pd.n1 * pd.n1;
                blk.assign((size_t)nca * ncb, 0.0);
                for (int ip = 0; ip < pd.nprim; ++ip) {
                    double p = pd.p[ip];
                    double pref = 2.0 * M_PI / p;
                    for (int k = 0; k < natm; ++k) {
                        double Z = atm_charges[k];
                        if (Z == 0.0) continue;
                        double X = pd.P[ip * 3 + 0] - atm_coords[3 * k + 0];
                        double Y = pd.P[ip * 3 + 1] - atm_coords[3 * k + 1];
                        double Zc = pd.P[ip * 3 + 2] - atm_coords[3 * k + 2];
                        r_tensor(pd.L, p, X, Y, Zc, rbox, rscr);
                        for (int xab = 0; xab < pd.cab; ++xab) {
                            size_t eb = (size_t)xab * nherm * pd.nprim;
                            double acc = 0.0;
                            for (int t = 0; t <= pd.L; ++t)
                            for (int u = 0; u <= pd.L - t; ++u)
                            for (int v = 0; v <= pd.L - t - u; ++v) {
                                size_t h = ((size_t)t * pd.n1 + u) * pd.n1 + v;
                                double e = pd.E[eb + h * pd.nprim + ip];
                                if (e != 0.0)
                                    acc += e * rbox[((size_t)t * (pd.L + 1) + u)
                                                    * (pd.L + 1) + v];
                            }
                            blk[xab] -= Z * pref * acc;
                        }
                    }
                }
                int nsa = nsph(la, cart), nsb = nsph(lb, cart);
                sph_bra(blk.data(), la, lb, 1, c2s, sp, tmp);
                int i0 = ao_off[i], j0 = ao_off[j];
                for (int ma = 0; ma < nsa; ++ma)
                    for (int mb = 0; mb < nsb; ++mb) {
                        double v = sp[(size_t)ma * nsb + mb];
                        out[(size_t)(i0 + ma) * nao + j0 + mb] = v;
                        out[(size_t)(j0 + mb) * nao + i0 + ma] = v;
                    }
            }
        }
    }
}

}  // extern "C"
