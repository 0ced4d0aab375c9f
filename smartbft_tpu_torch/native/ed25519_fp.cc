// Curve25519 field arithmetic + RFC 8032 point decompression.
//
// Ed25519 verification needs R (and A at registration) decompressed: a
// square root mod p = 2^255-19, which costs ~150 us per signature as a
// Python pow().  This moves it to microseconds of 64-bit limb arithmetic
// so the host prep of crypto/cuda_ed25519.py (one R decompression per
// signature) stops dominating the batch.
//
// Wire format: 32-byte little-endian compressed point (y with the x sign
// in bit 255) in; 64 bytes out (x||y, little-endian); rc 1 ok / 0 invalid.

#include <cstdint>
#include <cstring>

namespace {

using u64 = uint64_t;
using u128 = unsigned __int128;

constexpr int NL = 4;

// p = 2^255 - 19
constexpr u64 Pmod[NL] = {
    0xffffffffffffffedULL, 0xffffffffffffffffULL,
    0xffffffffffffffffULL, 0x7fffffffffffffffULL,
};

struct Fe {
    u64 v[NL];
};

// d = -121665/121666 mod p
constexpr Fe D = {{0x75eb4dca135978a3ULL, 0x00700a4d4141d8abULL,
                   0x8cc740797779e898ULL, 0x52036cee2b6ffe73ULL}};
// sqrt(-1) = 2^((p-1)/4) mod p
constexpr Fe SQRT_M1 = {{0xc4ee1b274a0ea0b0ULL, 0x2f431806ad2fe478ULL,
                         0x2b4d00993dfbd7a7ULL, 0x2b8324804fc1df0bULL}};

inline u64 adc(u64 a, u64 b, u64 &carry) {
    u128 t = (u128)a + b + carry;
    carry = (u64)(t >> 64);
    return (u64)t;
}

bool geq_p(const Fe &a) {
    for (int i = NL - 1; i >= 0; i--) {
        if (a.v[i] > Pmod[i]) return true;
        if (a.v[i] < Pmod[i]) return false;
    }
    return true;
}

void sub_p(Fe &a) {
    u128 br = 0;
    for (int i = 0; i < NL; i++) {
        u128 t = (u128)a.v[i] - Pmod[i] - br;
        a.v[i] = (u64)t;
        br = (t >> 64) & 1;
    }
}

Fe fe_reduce_once(Fe a) {
    if (geq_p(a)) sub_p(a);
    return a;
}

// full reduction of an 8-limb product: 2^256 = 38 mod p
Fe fe_from_wide(const u64 w[2 * NL]) {
    // fold high 256 bits: lo + hi*38 (lo < 39 * 2^256)
    u64 lo[NL + 1] = {0};
    u128 c = 0;
    for (int i = 0; i < NL; i++) {
        c += (u128)w[i] + (u128)w[NL + i] * 38;
        lo[i] = (u64)c;
        c >>= 64;
    }
    lo[NL] = (u64)c;  // <= 38
    // fold again: lo[NL]*2^256 = lo[NL]*38.  The addition below can carry
    // out of limb NL-1 once more (lo's low half may be close to 2^256),
    // so propagate THAT carry with a third 38-fold — it is at most 1, and
    // after adding 38 the low half is far from 2^256, so this terminates.
    c = (u128)lo[0] + (u128)lo[NL] * 38;
    Fe r;
    r.v[0] = (u64)c;
    c >>= 64;
    for (int i = 1; i < NL; i++) {
        c += lo[i];
        r.v[i] = (u64)c;
        c >>= 64;
    }
    if (c) {  // final carry: 2^256 ≡ 38
        u128 t = (u128)r.v[0] + 38;
        r.v[0] = (u64)t;
        t >>= 64;
        for (int i = 1; i < NL && t; i++) {
            t += r.v[i];
            r.v[i] = (u64)t;
            t >>= 64;
        }
    }
    r = fe_reduce_once(r);
    return fe_reduce_once(r);
}

Fe fe_mul(const Fe &a, const Fe &b) {
    u64 w[2 * NL] = {0};
    for (int i = 0; i < NL; i++) {
        u64 carry = 0;
        for (int j = 0; j < NL; j++) {
            u128 t = (u128)a.v[i] * b.v[j] + w[i + j] + carry;
            w[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        w[i + NL] = carry;
    }
    return fe_from_wide(w);
}

Fe fe_sqr(const Fe &a) { return fe_mul(a, a); }

Fe fe_add(const Fe &a, const Fe &b) {
    Fe r;
    u64 carry = 0;
    for (int i = 0; i < NL; i++) r.v[i] = adc(a.v[i], b.v[i], carry);
    // carry can set bit 256: fold via 38
    if (carry) {
        u128 c = (u128)r.v[0] + 38;
        r.v[0] = (u64)c;
        c >>= 64;
        for (int i = 1; i < NL && c; i++) {
            c += r.v[i];
            r.v[i] = (u64)c;
            c >>= 64;
        }
    }
    return fe_reduce_once(r);
}

Fe fe_sub(const Fe &a, const Fe &b) {
    Fe r;
    u128 br = 0;
    for (int i = 0; i < NL; i++) {
        u128 t = (u128)a.v[i] - b.v[i] - br;
        r.v[i] = (u64)t;
        br = (t >> 64) & 1;
    }
    if (br) {
        u64 carry = 0;
        for (int i = 0; i < NL; i++) r.v[i] = adc(r.v[i], Pmod[i], carry);
    }
    return r;
}

bool fe_is_zero(const Fe &a) {
    Fe r = fe_reduce_once(a);
    u64 acc = 0;
    for (int i = 0; i < NL; i++) acc |= r.v[i];
    return acc == 0;
}

bool fe_eq(const Fe &a, const Fe &b) { return fe_is_zero(fe_sub(a, b)); }

// a^e for a fixed 255-bit exponent given as limbs, MSB-first scan
Fe fe_pow(const Fe &a, const u64 e[NL]) {
    Fe acc = {{1, 0, 0, 0}};
    bool started = false;
    for (int i = NL - 1; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            if (started) acc = fe_sqr(acc);
            if ((e[i] >> b) & 1) {
                if (started) acc = fe_mul(acc, a);
                else { acc = a; started = true; }
            }
        }
    }
    return acc;
}

Fe fe_from_bytes_le(const uint8_t *in, bool mask_high) {
    Fe r;
    for (int i = 0; i < NL; i++) {
        u64 v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | in[i * 8 + j];
        r.v[i] = v;
    }
    if (mask_high) r.v[NL - 1] &= 0x7fffffffffffffffULL;
    return r;
}

void fe_to_bytes_le(const Fe &a, uint8_t *out) {
    Fe r = fe_reduce_once(fe_reduce_once(a));
    for (int i = 0; i < NL; i++) {
        u64 v = r.v[i];
        for (int j = 0; j < 8; j++) {
            out[i * 8 + j] = (uint8_t)(v >> (8 * j));
        }
    }
}

}  // namespace

extern "C" {

// RFC 8032 §5.1.3 decompression.  comp32: y || sign-bit (LE).
// out64 = x || y little-endian.  Returns 1, or 0 if invalid.
int smartbft_ed_decompress(const uint8_t *comp32, uint8_t *out64) {
    Fe y = fe_from_bytes_le(comp32, true);
    if (geq_p(y)) return 0;
    int sign = comp32[31] >> 7;

    Fe yy = fe_sqr(y);
    Fe one = {{1, 0, 0, 0}};
    Fe u = fe_sub(yy, one);             // y^2 - 1
    Fe v = fe_add(fe_mul(D, yy), one);  // d y^2 + 1

    // candidate x = u v^3 (u v^7)^((p-5)/8)
    Fe v3 = fe_mul(fe_sqr(v), v);
    Fe v7 = fe_mul(fe_sqr(v3), v);
    // (p-5)/8 = 2^252 - 3
    static const u64 E[NL] = {
        0xfffffffffffffffdULL, 0xffffffffffffffffULL,
        0xffffffffffffffffULL, 0x0fffffffffffffffULL,
    };
    Fe x = fe_mul(fe_mul(u, v3), fe_pow(fe_mul(u, v7), E));

    Fe vxx = fe_mul(v, fe_sqr(x));
    if (!fe_eq(vxx, u)) {
        if (fe_eq(vxx, fe_sub(Fe{{0, 0, 0, 0}}, u))) {
            x = fe_mul(x, SQRT_M1);
        } else {
            return 0;
        }
    }
    if (fe_is_zero(x) && sign) return 0;  // -0 is invalid
    uint8_t xb[32];
    fe_to_bytes_le(x, xb);
    if ((xb[0] & 1) != sign) {
        x = fe_sub(Fe{{0, 0, 0, 0}}, x);
    }
    fe_to_bytes_le(x, out64);
    fe_to_bytes_le(y, out64 + 32);
    return 1;
}

}  // extern "C"
