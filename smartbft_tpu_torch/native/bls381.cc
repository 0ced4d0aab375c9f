// BLS12-381 host-side group arithmetic: G1/G2 scalar multiplication and
// affine sums, exposed as byte-buffer C functions for ctypes.
//
// Replaces the pure-Python-int hot paths of crypto/bls12381.py — signing
// (sk * H(m), ~20 ms in Python), same-message aggregation (quorum-1 point
// adds per check), cofactor clearing, and the r-torsion subgroup checks —
// with 64-bit-limb Montgomery arithmetic (~30-80 us per scalar mult).
// Verification-side math only: no constant-time discipline is attempted
// (the reference's crypto is an app plugin; side channels are the
// embedder's concern, as with Go's non-constant-time big.Int paths).
//
// Wire format: field elements are 48-byte big-endian; G1 points are
// x||y (96 bytes), G2 points are x_c0||x_c1||y_c0||y_c1 (192 bytes);
// infinity is returned as rc=0 with the output zeroed.

#include <cstdint>
#include <cstring>

using u64 = uint64_t;
using u128 = unsigned __int128;

namespace {

constexpr int NL = 6;  // 6 x 64-bit limbs, little-endian

// p = 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab
constexpr u64 Pmod[NL] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL,
};
// -p^-1 mod 2^64
constexpr u64 PINV = 0x89f3fffcfffcfffdULL;
// R^2 mod p (R = 2^384)
constexpr u64 R2[NL] = {
    0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL,
    0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL,
};

struct Fp {
    u64 v[NL];
};

bool fp_is_zero(const Fp &a) {
    u64 acc = 0;
    for (int i = 0; i < NL; i++) acc |= a.v[i];
    return acc == 0;
}

bool fp_eq(const Fp &a, const Fp &b) {
    u64 acc = 0;
    for (int i = 0; i < NL; i++) acc |= a.v[i] ^ b.v[i];
    return acc == 0;
}

// a += b with carry out
inline u64 add_limbs(u64 *a, const u64 *b) {
    u128 c = 0;
    for (int i = 0; i < NL; i++) {
        c += (u128)a[i] + b[i];
        a[i] = (u64)c;
        c >>= 64;
    }
    return (u64)c;
}

// a -= b with borrow out
inline u64 sub_limbs(u64 *a, const u64 *b) {
    u128 br = 0;
    for (int i = 0; i < NL; i++) {
        u128 t = (u128)a[i] - b[i] - br;
        a[i] = (u64)t;
        br = (t >> 64) & 1;
    }
    return (u64)br;
}

inline bool geq_p(const u64 *a) {
    for (int i = NL - 1; i >= 0; i--) {
        if (a[i] > Pmod[i]) return true;
        if (a[i] < Pmod[i]) return false;
    }
    return true;  // equal
}

Fp fp_add(const Fp &a, const Fp &b) {
    Fp r = a;
    u64 carry = add_limbs(r.v, b.v);
    if (carry || geq_p(r.v)) sub_limbs(r.v, Pmod);
    return r;
}

Fp fp_sub(const Fp &a, const Fp &b) {
    Fp r = a;
    if (sub_limbs(r.v, b.v)) add_limbs(r.v, Pmod);
    return r;
}

Fp fp_neg(const Fp &a) {
    if (fp_is_zero(a)) return a;
    Fp r;
    for (int i = 0; i < NL; i++) r.v[i] = Pmod[i];
    sub_limbs(r.v, a.v);
    return r;
}

// CIOS Montgomery multiplication with the "no-carry" optimization: because
// p's top limb (0x1a01..) is below 2^63 - 1, the per-iteration partial sums
// fit NL limbs plus two scalar carries (c0 from the product pass, c1 from
// the reduction pass) — no NL+2 tail bookkeeping.  ~25% faster than the
// classic CIOS here: the compiler keeps t[] and both carries in registers.
// PRECONDITION: both operands < p (the dropped tail carry is only provably
// zero then).  Every byte ingress reduces first (fp_from_bytes_be), and
// all internal arithmetic is closed over [0, p).
Fp fp_mul(const Fp &A, const Fp &B) {
    const u64 *a = A.v, *b = B.v;
    u64 t[NL];
    {
        u128 p = (u128)a[0] * b[0];
        t[0] = (u64)p;
        u64 c0 = (u64)(p >> 64);
        for (int j = 1; j < NL; j++) {
            p = (u128)a[0] * b[j] + c0;
            t[j] = (u64)p;
            c0 = (u64)(p >> 64);
        }
        u64 c2 = c0;
        u64 m = t[0] * PINV;
        p = (u128)m * Pmod[0] + t[0];
        u64 c1 = (u64)(p >> 64);
        for (int j = 1; j < NL; j++) {
            p = (u128)m * Pmod[j] + t[j] + c1;
            t[j - 1] = (u64)p;
            c1 = (u64)(p >> 64);
        }
        t[NL - 1] = c1 + c2;
    }
    for (int i = 1; i < NL; i++) {
        u128 p = (u128)a[i] * b[0] + t[0];
        t[0] = (u64)p;
        u64 c0 = (u64)(p >> 64);
        for (int j = 1; j < NL; j++) {
            p = (u128)a[i] * b[j] + t[j] + c0;
            t[j] = (u64)p;
            c0 = (u64)(p >> 64);
        }
        u64 c2 = c0;
        u64 m = t[0] * PINV;
        p = (u128)m * Pmod[0] + t[0];
        u64 c1 = (u64)(p >> 64);
        for (int j = 1; j < NL; j++) {
            p = (u128)m * Pmod[j] + t[j] + c1;
            t[j - 1] = (u64)p;
            c1 = (u64)(p >> 64);
        }
        t[NL - 1] = c1 + c2;
    }
    Fp r;
    for (int i = 0; i < NL; i++) r.v[i] = t[i];
    if (geq_p(r.v)) sub_limbs(r.v, Pmod);
    return r;
}

Fp fp_sqr(const Fp &a) { return fp_mul(a, a); }

Fp fp_from_bytes_be(const uint8_t *in) {
    Fp raw;
    for (int i = 0; i < NL; i++) {
        u64 v = 0;
        for (int j = 0; j < 8; j++) v = (v << 8) | in[(NL - 1 - i) * 8 + j];
        raw.v[i] = v;
    }
    // Reduce non-canonical encodings (values in [p, 2^384)) BEFORE the
    // domain conversion: the no-carry fp_mul requires both operands < p
    // (its dropped tail carry is only provably zero then), so unreduced
    // bytes fed straight through would corrupt silently.  At most 2^384/p
    // ≈ 9.8 subtractions, and canonical inputs pay one compare.
    while (geq_p(raw.v)) sub_limbs(raw.v, Pmod);
    Fp r2;
    for (int i = 0; i < NL; i++) r2.v[i] = R2[i];
    return fp_mul(raw, r2);  // into Montgomery domain
}

void fp_to_bytes_be(const Fp &a, uint8_t *out) {
    Fp one;
    for (int i = 0; i < NL; i++) one.v[i] = 0;
    one.v[0] = 1;
    Fp std = fp_mul(a, one);  // out of Montgomery domain
    for (int i = 0; i < NL; i++) {
        u64 v = std.v[i];
        for (int j = 7; j >= 0; j--) {
            out[(NL - 1 - i) * 8 + (7 - j)] = (uint8_t)(v >> (8 * j));
        }
    }
}

// Binary extended GCD inversion: ~760 shift/add iterations on 6 limbs
// (~5 us) vs ~570 Montgomery multiplications for the Fermat ladder
// (~50 us).  Input and output both in the Montgomery domain.
// Not constant-time, like everything in this file (see header note).

inline bool limbs_is_zero(const u64 *a) {
    u64 acc = 0;
    for (int i = 0; i < NL; i++) acc |= a[i];
    return acc == 0;
}

inline bool limbs_lt(const u64 *a, const u64 *b) {
    for (int i = NL - 1; i >= 0; i--) {
        if (a[i] < b[i]) return true;
        if (a[i] > b[i]) return false;
    }
    return false;
}

inline void limbs_rshift1(u64 *a) {
    for (int i = 0; i < NL - 1; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 63);
    a[NL - 1] >>= 1;
}

Fp fp_inv(const Fp &a) {
    // a is aR mod p; classic binary xgcd computes (aR)^-1 mod p, then two
    // Montgomery multiplications by R^2 lift it back to (a^-1)R.
    if (fp_is_zero(a)) return a;
    u64 u[NL], v[NL], b[NL] = {1, 0, 0, 0, 0, 0}, c[NL] = {0};
    for (int i = 0; i < NL; i++) {
        u[i] = a.v[i];
        v[i] = Pmod[i];
    }
    while (!limbs_is_zero(u)) {
        while (!(u[0] & 1)) {
            limbs_rshift1(u);
            if (b[0] & 1) add_limbs(b, Pmod);
            limbs_rshift1(b);
        }
        while (!(v[0] & 1)) {
            limbs_rshift1(v);
            if (c[0] & 1) add_limbs(c, Pmod);
            limbs_rshift1(c);
        }
        // on u == v (then necessarily u == v == gcd == 1) the subtraction
        // MUST land on u so the outer loop terminates: v -= u would zero v
        // and wedge the even-stripping loop on a value that never goes odd
        if (!limbs_lt(u, v)) {
            sub_limbs(u, v);
            if (sub_limbs(b, c)) add_limbs(b, Pmod);
        } else {
            sub_limbs(v, u);
            if (sub_limbs(c, b)) add_limbs(c, Pmod);
        }
    }
    // v == gcd == 1 (p prime, a != 0); c == (aR)^-1 mod p
    Fp inv_std;
    for (int i = 0; i < NL; i++) inv_std.v[i] = c[i];
    Fp r2;
    for (int i = 0; i < NL; i++) r2.v[i] = R2[i];
    return fp_mul(fp_mul(inv_std, r2), r2);
}

Fp fp_inv_fermat(const Fp &a) {
    // Fermat: a^(p-2).  Exponent p-2 processed MSB-first.
    u64 e[NL];
    for (int i = 0; i < NL; i++) e[i] = Pmod[i];
    e[0] -= 2;  // p is odd and > 2, no borrow
    Fp one;
    for (int i = 0; i < NL; i++) one.v[i] = 0;
    one.v[0] = 1;
    Fp r2;
    for (int i = 0; i < NL; i++) r2.v[i] = R2[i];
    Fp acc = fp_mul(one, r2);  // 1 in Montgomery form
    for (int i = NL - 1; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            acc = fp_sqr(acc);
            if ((e[i] >> b) & 1) acc = fp_mul(acc, a);
        }
    }
    return acc;
}

// ---------------- Fp2 = Fp[u]/(u^2+1) ----------------

struct Fp2 {
    Fp c0, c1;
};

bool fp2_is_zero(const Fp2 &a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }
bool fp2_eq(const Fp2 &a, const Fp2 &b) {
    return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}
Fp2 fp2_add(const Fp2 &a, const Fp2 &b) {
    return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}
Fp2 fp2_sub(const Fp2 &a, const Fp2 &b) {
    return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}
Fp2 fp2_neg(const Fp2 &a) { return {fp_neg(a.c0), fp_neg(a.c1)}; }
Fp2 fp2_mul(const Fp2 &a, const Fp2 &b) {
    Fp t0 = fp_mul(a.c0, b.c0);
    Fp t1 = fp_mul(a.c1, b.c1);
    Fp s = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
    return {fp_sub(t0, t1), fp_sub(fp_sub(s, t0), t1)};
}
Fp2 fp2_sqr(const Fp2 &a) {
    // complex squaring over u^2 = -1: (c0+c1u)^2 = (c0+c1)(c0-c1) + 2c0c1 u
    Fp t = fp_mul(a.c0, a.c1);
    return {fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1)), fp_add(t, t)};
}
Fp2 fp2_inv(const Fp2 &a) {
    // 1/(c0 + c1 u) = (c0 - c1 u) / (c0^2 + c1^2)
    Fp d = fp_add(fp_sqr(a.c0), fp_sqr(a.c1));
    Fp di = fp_inv(d);
    return {fp_mul(a.c0, di), fp_neg(fp_mul(a.c1, di))};
}

// ---------------- generic Jacobian group ops -----------------------------
// Curve y^2 = x^3 + b with a = 0 (both G1 and G2).  F supplies field ops.

template <typename F>
struct Jac {
    typename F::El X, Y, Z;
    bool inf;
};

struct OpsFp {
    using El = Fp;
    static El add(const El &a, const El &b) { return fp_add(a, b); }
    static El sub(const El &a, const El &b) { return fp_sub(a, b); }
    static El mul(const El &a, const El &b) { return fp_mul(a, b); }
    static El sqr(const El &a) { return fp_sqr(a); }
    static El inv(const El &a) { return fp_inv(a); }
    static bool is_zero(const El &a) { return fp_is_zero(a); }
    static bool eq(const El &a, const El &b) { return fp_eq(a, b); }
    static El one() {
        Fp one;
        for (int i = 0; i < NL; i++) one.v[i] = 0;
        one.v[0] = 1;
        Fp r2;
        for (int i = 0; i < NL; i++) r2.v[i] = R2[i];
        return fp_mul(one, r2);
    }
};

struct OpsFp2 {
    using El = Fp2;
    static El add(const El &a, const El &b) { return fp2_add(a, b); }
    static El sub(const El &a, const El &b) { return fp2_sub(a, b); }
    static El mul(const El &a, const El &b) { return fp2_mul(a, b); }
    static El sqr(const El &a) { return fp2_sqr(a); }
    static El inv(const El &a) { return fp2_inv(a); }
    static bool is_zero(const El &a) { return fp2_is_zero(a); }
    static bool eq(const El &a, const El &b) { return fp2_eq(a, b); }
    static El one() { return {OpsFp::one(), Fp{{0, 0, 0, 0, 0, 0}}}; }
};

template <typename F>
Jac<F> jac_dbl(const Jac<F> &p) {
    if (p.inf || F::is_zero(p.Y)) return {p.X, p.Y, p.Z, true};
    // dbl-2009-l (a = 0)
    auto A = F::sqr(p.X);
    auto Bv = F::sqr(p.Y);
    auto C = F::sqr(Bv);
    auto t = F::sub(F::sub(F::sqr(F::add(p.X, Bv)), A), C);
    auto D = F::add(t, t);
    auto E = F::add(F::add(A, A), A);
    auto Fv = F::sqr(E);
    auto X3 = F::sub(Fv, F::add(D, D));
    auto C8 = F::add(F::add(F::add(C, C), F::add(C, C)),
                     F::add(F::add(C, C), F::add(C, C)));
    auto Y3 = F::sub(F::mul(E, F::sub(D, X3)), C8);
    auto Z3 = F::mul(F::add(p.Y, p.Y), p.Z);
    return {X3, Y3, Z3, false};
}

template <typename F>
Jac<F> jac_add(const Jac<F> &p, const Jac<F> &q) {
    if (p.inf) return q;
    if (q.inf) return p;
    auto Z1Z1 = F::sqr(p.Z);
    auto Z2Z2 = F::sqr(q.Z);
    auto U1 = F::mul(p.X, Z2Z2);
    auto U2 = F::mul(q.X, Z1Z1);
    auto S1 = F::mul(F::mul(p.Y, q.Z), Z2Z2);
    auto S2 = F::mul(F::mul(q.Y, p.Z), Z1Z1);
    auto H = F::sub(U2, U1);
    auto r = F::sub(S2, S1);
    if (F::is_zero(H)) {
        if (F::is_zero(r)) return jac_dbl(p);
        return {p.X, p.Y, p.Z, true};  // P + (-P) = inf
    }
    auto H2 = F::sqr(H);
    auto H3 = F::mul(H2, H);
    auto U1H2 = F::mul(U1, H2);
    auto X3 = F::sub(F::sub(F::sqr(r), H3), F::add(U1H2, U1H2));
    auto Y3 = F::sub(F::mul(r, F::sub(U1H2, X3)), F::mul(S1, H3));
    auto Z3 = F::mul(F::mul(p.Z, q.Z), H);
    return {X3, Y3, Z3, false};
}

template <typename F>
Jac<F> jac_mul(const uint8_t *scalar, size_t slen, const Jac<F> &p) {
    // 4-bit fixed window, nibbles MSB-first: 14 table adds + (4 dbl +
    // <=1 add) per nibble — ~28% fewer point ops than double-and-add.
    Jac<F> table[16];
    table[0] = {p.X, p.Y, p.Z, true};
    table[1] = p;
    for (int i = 2; i < 16; i++) table[i] = jac_add(table[i - 1], p);
    Jac<F> acc = table[0];
    for (size_t i = 0; i < slen; i++) {
        uint8_t byte = scalar[i];  // big-endian: MSB first
        for (int half = 0; half < 2; half++) {
            for (int d = 0; d < 4; d++) acc = jac_dbl(acc);
            uint8_t nib = half == 0 ? (byte >> 4) : (byte & 0xF);
            if (nib) acc = jac_add(acc, table[nib]);
        }
    }
    return acc;
}

// ---------------- G1 GLV multiplication --------------------------------
//
// The curve has the efficient endomorphism phi(x, y) = (beta*x, y) with
// phi(P) = lambda*P for P in the r-torsion, where lambda = z^2 - 1
// satisfies lambda^2 + lambda + 1 = r exactly.  A scalar k < r splits as
// k = k1 + k2*lambda with both halves <= 128 bits (k2 = floor(k*MU/2^256)
// with MU = floor(2^256/lambda), then a <=2-step correction), so the
// double-and-add ladder runs 128 doublings instead of 255.  Each half
// walks width-5 wNAF digits against an odd-multiple table normalized to
// affine with ONE batch inversion; phi maps the table for free (scale X
// by beta).  ONLY valid for r-torsion points — subgroup checks and
// cofactor clearing must keep using the generic ladder.

constexpr u64 LAM[2] = {0x00000000ffffffffULL, 0xac45a4010001a402ULL};
constexpr u64 MU[3] = {0x63f6e522f6cfee30ULL, 0x7c6becf1e01faaddULL, 0x1ULL};
// beta (Montgomery form computed at first use)
constexpr u64 BETA_STD[NL] = {
    0x8bfd00000000aaacULL, 0x409427eb4f49fffdULL, 0x897d29650fb85f9bULL,
    0xaa0d857d89759ad4ULL, 0xec02408663d4de85ULL, 0x1a0111ea397fe699ULL,
};

// k (<= 4 limbs, little-endian) -> (k1, k2), both <= 129 bits.
void glv_split(const u64 k[4], u64 k1[3], u64 k2[3]) {
    // k2 = (k * MU) >> 256
    u64 prod[7] = {0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 3; j++) {
            c += (u128)prod[i + j] + (u128)k[i] * MU[j];
            prod[i + j] = (u64)c;
            c >>= 64;
        }
        prod[i + 3] += (u64)c;
    }
    for (int i = 0; i < 3; i++) k2[i] = prod[4 + i];
    // k1 = k - k2 * LAM  (fits 4 limbs; result < lambda after correction)
    u64 t[5] = {0};
    for (int i = 0; i < 3; i++) {
        u128 c = 0;
        for (int j = 0; j < 2; j++) {
            c += (u128)t[i + j] + (u128)k2[i] * LAM[j];
            t[i + j] = (u64)c;
            c >>= 64;
        }
        t[i + 2] += (u64)c;
    }
    u64 r1[4];
    u128 br = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)k[i] - t[i] - br;
        r1[i] = (u64)d;
        br = (d >> 64) & 1;
    }
    // correction: while k1 >= lambda { k1 -= lambda; k2 += 1 }
    auto ge_lam = [&]() {
        if (r1[3] | r1[2]) return true;
        if (r1[1] != LAM[1]) return r1[1] > LAM[1];
        return r1[0] >= LAM[0];
    };
    while (ge_lam()) {
        u128 d = (u128)r1[0] - LAM[0];
        r1[0] = (u64)d;
        u128 b2 = (d >> 64) & 1;
        d = (u128)r1[1] - LAM[1] - b2;
        r1[1] = (u64)d;
        b2 = (d >> 64) & 1;
        d = (u128)r1[2] - b2;
        r1[2] = (u64)d;
        r1[3] -= (u64)((d >> 64) & 1);
        u128 c = (u128)k2[0] + 1;
        k2[0] = (u64)c;
        if (c >> 64) {
            c = (u128)k2[1] + 1;
            k2[1] = (u64)c;
            k2[2] += (u64)(c >> 64);
        }
    }
    for (int i = 0; i < 3; i++) k1[i] = r1[i];
}

// width-5 wNAF: odd digits in [-15, 15], ~1/6 density.  digits[i] is the
// coefficient of 2^i; returns the digit count (caller scans len-1 .. 0).
int wnaf5(const u64 k_in[3], int8_t *digits, int cap) {
    u64 k[3] = {k_in[0], k_in[1], k_in[2]};
    int len = 0;
    while (k[0] | k[1] | k[2]) {
        int8_t d = 0;
        if (k[0] & 1) {
            int v = (int)(k[0] & 31);
            d = (int8_t)(v > 16 ? v - 32 : v);
            // k -= d
            if (d > 0) {
                u128 br = 0;
                u64 dv = (u64)d;
                u128 t = (u128)k[0] - dv;
                k[0] = (u64)t;
                br = (t >> 64) & 1;
                for (int i = 1; br && i < 3; i++) {
                    t = (u128)k[i] - br;
                    k[i] = (u64)t;
                    br = (t >> 64) & 1;
                }
            } else {
                u128 c = (u128)k[0] + (u64)(-d);
                k[0] = (u64)c;
                for (int i = 1; (c >>= 64) && i < 3; i++) {
                    c += k[i];
                    k[i] = (u64)c;
                }
            }
        }
        digits[len++] = d;
        if (len >= cap) break;
        k[0] = (k[0] >> 1) | (k[1] << 63);
        k[1] = (k[1] >> 1) | (k[2] << 63);
        k[2] >>= 1;
    }
    return len;
}

struct AffG1 {
    Fp x, y;
    bool inf;
};

// mixed Jacobian + affine addition (Z2 = 1): 8M + 3S
Jac<OpsFp> jac_madd(const Jac<OpsFp> &p, const AffG1 &q) {
    if (q.inf) return p;
    if (p.inf) return {q.x, q.y, OpsFp::one(), false};
    Fp z1z1 = fp_sqr(p.Z);
    Fp u2 = fp_mul(q.x, z1z1);
    Fp s2 = fp_mul(fp_mul(q.y, p.Z), z1z1);
    Fp h = fp_sub(u2, p.X);
    Fp rr = fp_sub(s2, p.Y);
    if (fp_is_zero(h)) {
        if (fp_is_zero(rr)) return jac_dbl(p);
        return {p.X, p.Y, p.Z, true};
    }
    Fp h2 = fp_sqr(h);
    Fp h3 = fp_mul(h, h2);
    Fp v = fp_mul(p.X, h2);
    Fp x3 = fp_sub(fp_sub(fp_sqr(rr), h3), fp_add(v, v));
    Fp y3 = fp_sub(fp_mul(rr, fp_sub(v, x3)), fp_mul(p.Y, h3));
    Fp z3 = fp_mul(p.Z, h);
    return {x3, y3, z3, false};
}

// normalize 8 Jacobian points to affine with ONE inversion (Montgomery's
// batch trick: prefix products, single xgcd, unwind).
void batch_to_affine(const Jac<OpsFp> *pts, AffG1 *out, int n) {
    Fp acc = OpsFp::one();
    Fp prefix[16];
    for (int i = 0; i < n; i++) {
        prefix[i] = acc;
        if (!pts[i].inf) acc = fp_mul(acc, pts[i].Z);
    }
    Fp inv = fp_inv(acc);
    for (int i = n - 1; i >= 0; i--) {
        if (pts[i].inf) {
            out[i].inf = true;
            continue;
        }
        Fp zi = fp_mul(inv, prefix[i]);
        inv = fp_mul(inv, pts[i].Z);
        Fp zi2 = fp_sqr(zi);
        out[i].x = fp_mul(pts[i].X, zi2);
        out[i].y = fp_mul(pts[i].Y, fp_mul(zi2, zi));
        out[i].inf = false;
    }
}

// k * P for P in the r-torsion, k < 2^255 (4 limbs little-endian).
Jac<OpsFp> jac_mul_glv(const u64 k[4], const Jac<OpsFp> &p) {
    Jac<OpsFp> nothing = {p.X, p.Y, p.Z, true};
    if (p.inf) return nothing;
    u64 k1[3], k2[3];
    glv_split(k, k1, k2);

    // odd multiples 1P, 3P, ..., 15P (Jacobian), then one batch inversion
    Jac<OpsFp> tj[8];
    tj[0] = p;
    Jac<OpsFp> p2 = jac_dbl(p);
    for (int i = 1; i < 8; i++) tj[i] = jac_add(tj[i - 1], p2);
    AffG1 tp[8], tphi[8];
    batch_to_affine(tj, tp, 8);
    // phi table: x *= beta (beta in Montgomery form)
    Fp beta_std, r2;
    for (int i = 0; i < NL; i++) {
        beta_std.v[i] = BETA_STD[i];
        r2.v[i] = R2[i];
    }
    Fp beta_m = fp_mul(beta_std, r2);
    for (int i = 0; i < 8; i++) {
        tphi[i] = tp[i];
        if (!tp[i].inf) tphi[i].x = fp_mul(tp[i].x, beta_m);
    }

    int8_t d1[132], d2[132];
    int l1 = wnaf5(k1, d1, 132);
    int l2 = wnaf5(k2, d2, 132);
    int len = l1 > l2 ? l1 : l2;
    Jac<OpsFp> acc = nothing;
    for (int i = len - 1; i >= 0; i--) {
        acc = jac_dbl(acc);
        if (i < l1 && d1[i]) {
            AffG1 q = tp[(d1[i] > 0 ? d1[i] : -d1[i]) >> 1];
            if (d1[i] < 0) q.y = fp_neg(q.y);
            acc = jac_madd(acc, q);
        }
        if (i < l2 && d2[i]) {
            AffG1 q = tphi[(d2[i] > 0 ? d2[i] : -d2[i]) >> 1];
            if (d2[i] < 0) q.y = fp_neg(q.y);
            acc = jac_madd(acc, q);
        }
    }
    return acc;
}

template <typename F>
bool jac_to_affine(const Jac<F> &p, typename F::El &x, typename F::El &y) {
    if (p.inf || F::is_zero(p.Z)) return false;
    auto zi = F::inv(p.Z);
    auto zi2 = F::sqr(zi);
    x = F::mul(p.X, zi2);
    y = F::mul(p.Y, F::mul(zi2, zi));
    return true;
}

// -------- byte-interface helpers --------

Jac<OpsFp> g1_from_bytes(const uint8_t *xy96) {
    Jac<OpsFp> p;
    p.X = fp_from_bytes_be(xy96);
    p.Y = fp_from_bytes_be(xy96 + 48);
    p.Z = OpsFp::one();
    p.inf = fp_is_zero(p.X) && fp_is_zero(p.Y);
    return p;
}

int g1_to_bytes(const Jac<OpsFp> &p, uint8_t *out96) {
    Fp x, y;
    if (!jac_to_affine<OpsFp>(p, x, y)) {
        memset(out96, 0, 96);
        return 0;
    }
    fp_to_bytes_be(x, out96);
    fp_to_bytes_be(y, out96 + 48);
    return 1;
}

Jac<OpsFp2> g2_from_bytes(const uint8_t *b192) {
    Jac<OpsFp2> p;
    p.X = {fp_from_bytes_be(b192), fp_from_bytes_be(b192 + 48)};
    p.Y = {fp_from_bytes_be(b192 + 96), fp_from_bytes_be(b192 + 144)};
    p.Z = OpsFp2::one();
    p.inf = fp2_is_zero(p.X) && fp2_is_zero(p.Y);
    return p;
}

int g2_to_bytes(const Jac<OpsFp2> &p, uint8_t *out192) {
    Fp2 x, y;
    if (!jac_to_affine<OpsFp2>(p, x, y)) {
        memset(out192, 0, 192);
        return 0;
    }
    fp_to_bytes_be(x.c0, out192);
    fp_to_bytes_be(x.c1, out192 + 48);
    fp_to_bytes_be(y.c0, out192 + 96);
    fp_to_bytes_be(y.c1, out192 + 144);
    return 1;
}

}  // namespace

extern "C" {

// k * P for affine G1 P; returns 1, or 0 when the result is infinity.
int smartbft_bls_g1_mul(const uint8_t *scalar, size_t slen,
                        const uint8_t *xy96, uint8_t *out96) {
    Jac<OpsFp> p = g1_from_bytes(xy96);
    return g1_to_bytes(jac_mul<OpsFp>(scalar, slen, p), out96);
}

// GLV-accelerated k * P — ONLY for P already known to lie in the r-torsion
// (signing against a hash-to-curve output, multiplying a validated public
// key).  Subgroup checks and cofactor clearing MUST use smartbft_bls_g1_mul:
// phi(P) = lambda*P does not hold off the subgroup, which is exactly what
// those callers are probing.  Falls back to the generic ladder for scalars
// longer than 32 bytes.
int smartbft_bls_g1_mul_glv(const uint8_t *scalar, size_t slen,
                            const uint8_t *xy96, uint8_t *out96) {
    Jac<OpsFp> p = g1_from_bytes(xy96);
    if (slen > 32) return g1_to_bytes(jac_mul<OpsFp>(scalar, slen, p), out96);
    u64 k[4] = {0, 0, 0, 0};
    for (size_t i = 0; i < slen; i++) {
        k[(slen - 1 - i) / 8] |= (u64)scalar[i] << (8 * ((slen - 1 - i) % 8));
    }
    return g1_to_bytes(jac_mul_glv(k, p), out96);
}

// Sum of n affine G1 points (each 96 bytes); rc as above.
int smartbft_bls_g1_sum(const uint8_t *pts, size_t n, uint8_t *out96) {
    Jac<OpsFp> acc;
    acc.inf = true;
    acc.Z = OpsFp::one();
    acc.X = acc.Y = acc.Z;
    for (size_t i = 0; i < n; i++) {
        acc = jac_add(acc, g1_from_bytes(pts + 96 * i));
    }
    return g1_to_bytes(acc, out96);
}

int smartbft_bls_g2_mul(const uint8_t *scalar, size_t slen,
                        const uint8_t *b192, uint8_t *out192) {
    Jac<OpsFp2> p = g2_from_bytes(b192);
    return g2_to_bytes(jac_mul<OpsFp2>(scalar, slen, p), out192);
}

int smartbft_bls_g2_sum(const uint8_t *pts, size_t n, uint8_t *out192) {
    Jac<OpsFp2> acc;
    acc.inf = true;
    acc.Z = OpsFp2::one();
    acc.X = acc.Y = acc.Z;
    for (size_t i = 0; i < n; i++) {
        acc = jac_add(acc, g2_from_bytes(pts + 192 * i));
    }
    return g2_to_bytes(acc, out192);
}

}  // extern "C"
