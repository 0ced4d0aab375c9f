"""Static-key comb Ed25519 verify: tables, packing, the engine adapter, the
CUDA kernel and its plain-torch version.

Port of the TPU kernel ``smartbft_tpu/crypto/pallas_ed25519.py``
(``_kernel``, driven by ``eddsa_verify_comb``).  The cofactorless
equation [S]B == R + [h]A is checked as [S]B + [h](-A) == R.  Both bases
are static — B is the RFC 8032 base point and A one of n replica keys
fixed at configuration — so each gets a host-precomputed Lim–Lee comb
table (8 teeth, stride 32), the key tables holding the NEGATED key so the
walk only adds: 32 × (one doubling + two unified additions), no
inversion.  A key is decoded and checked on the curve once, at
registration; R arrives with every signature and is checked in the kernel.

Tables are uint32 Montgomery words shaped ``(npad, 256, 3, 8)``: affine
(X, Y, T = x·y) with Z = 1 implicit, entry 0 the identity (0, 1, 0).  The
CUDA kernel reads the same words as plain numbers, the extended point
(x·R : y·R : R : x·y·R) with R = 2^256 ≡ 38 (mod p), so neither side
converts them.  The TPU kernel's split-byte bf16 rows and one-hot matmul
select are not carried over: a lookup is a direct load ``btab[digit]`` /
``qtab[kidx][digit]``.  :func:`from_jax_tables` (shared with P-256, whose
96-row layout is the same) carries the JAX package's tables over.

* :func:`eddsa_verify_comb` is the wrapper: CUDA tensors launch
  ``csrc/cuda_ed25519.cu`` (counted in :data:`LAUNCHES`), CPU tensors run
  :func:`eddsa_verify_comb_plain`; there is no fallback between them.
* :func:`pack_items` is the host prep (SHA-512 binding hash mod L, R
  decompression, S < L), folding every host failure into ``ok``.
* :class:`Ed25519CombVerifier` plugs the Edwards hooks into
  :class:`~.cuda_comb.CombVerifier`'s registry and launch scaffolding.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import csrc
from . import ed25519 as ed
from .bignum import bytes_to_limbs, eq, grp, is_zero, words_to_limbs
from .cuda_comb import (
    STRIDE,
    TEETH,
    TSIZE,
    CombKeyRegistry,
    CombVerifier,
    comb_digits,
    from_jax_tables,  # noqa: F401 — the 96-row JAX layout is shared
)
from .cuda_ecdsa import _check_bytes, as_tensor
from .cuda_eddsa import (
    check_lanes,
    curve,
    is_on_curve,
    on_curve_lanes,
    point_add,
    point_double,
)
from .ed25519 import BX, BY, D, L, P
from .opcount import EDWARDS, PROJ, comb_walk, lane_array, walk_ops

#: launches and lanes of the CUDA kernel
LAUNCHES = csrc.LaunchCounter("ed_comb_verify")


# ---------------------------------------------------------------------------
# host-side tables (Python ints; once per key per process)
# ---------------------------------------------------------------------------


def is_on_curve_int(pt) -> bool:
    """-x² + y² == 1 + d x² y² (mod p) for an affine Edwards point."""
    x, y = pt
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - x * x - 1 - D * x * x % P * (y * y % P)) % P == 0


def _comb_entries(point) -> list:
    """All 2^TEETH subset sums of {2^(STRIDE·t)·point : t < TEETH}."""
    bases = [point]
    for _ in range(TEETH - 1):
        b = bases[-1]
        for _ in range(STRIDE):
            b = ed._aff_add(b, b)
        bases.append(b)
    table = [(0, 1)] * TSIZE
    for idx in range(1, TSIZE):
        low = idx & -idx
        table[idx] = ed._aff_add(table[idx ^ low], bases[low.bit_length() - 1])
    return table


def _mont_words(v: int) -> np.ndarray:
    return np.frombuffer(((v << 256) % P).to_bytes(32, "little"),
                         np.uint32)


def build_table(point) -> np.ndarray:
    """(256, 3, 8) uint32 comb table for one affine Edwards point: entry idx
    holds (X, Y, T = x·y) in Montgomery words, Z = 1 implicit (the identity
    (0, 1) is an ordinary affine point here)."""
    out = np.zeros((TSIZE, 3, 8), np.uint32)
    for idx, (x, y) in enumerate(_comb_entries(point)):
        out[idx] = (_mont_words(x), _mont_words(y), _mont_words(x * y % P))
    return out


def _neg_pub_table(pub_pt) -> np.ndarray:
    """Comb table of -A for a decompressed public point A."""
    x, y = pub_pt
    return build_table(((P - x) % P, y))


@functools.lru_cache(maxsize=1)
def b_table() -> np.ndarray:
    """The base point's comb table (shared by every verification)."""
    return build_table((BX, BY))


def _validate_pub(pub: bytes):
    """Decompress and check a compressed public key; returns the point."""
    pt = ed.decompress(pub) if isinstance(pub, bytes) else None
    if pt is None or not is_on_curve_int(pt):
        raise ValueError("public key is not on the Ed25519 curve")
    return pt


def _build_key_table(pub: bytes) -> np.ndarray:
    return _neg_pub_table(_validate_pub(pub))


def pack_items(items, registry) -> tuple:
    """items -> ((B, 32) uint8 s, h, rx, ry; (B,) int32 ok; (B,) int32 kidx).

    Host work as the JAX package's: SHA-512 binding hash mod L, R
    decompression, the RFC 8032 S < L check.  A lane failing any host
    check gets ok = 0 and zero values (the kernel returns 0 for it)."""
    bsz = len(items)
    s8, h8, rx8, ry8 = (np.zeros((bsz, 32), np.uint8) for _ in range(4))
    ok = np.zeros(bsz, np.int32)
    kidx = np.zeros(bsz, np.int32)
    for i, (msg, sig, pub) in enumerate(items):
        kidx[i] = registry.register(pub)
        if len(sig) != 64:
            continue
        s_int = int.from_bytes(sig[32:], "little")
        if s_int >= L:
            continue
        rpt = ed.decompress(sig[:32])
        if rpt is None:
            continue
        s8[i] = np.frombuffer(sig[32:], np.uint8)
        h8[i] = np.frombuffer(
            ed.binding_hash(sig[:32], pub, msg).to_bytes(32, "little"),
            np.uint8)
        rx8[i] = np.frombuffer(rpt[0].to_bytes(32, "little"), np.uint8)
        ry8[i] = np.frombuffer(rpt[1].to_bytes(32, "little"), np.uint8)
        ok[i] = 1
    return s8, h8, rx8, ry8, ok, kidx


# ---------------------------------------------------------------------------
# the plain-torch version
# ---------------------------------------------------------------------------


def eddsa_verify_comb_plain(s, h, rx, ry, ok, kidx, btab, qtab) -> torch.Tensor:
    """The comb verify in plain torch; (B,) int32 mask on the inputs'
    device.  ``s, h, rx, ry``: (B, 32) uint8; ``ok``, ``kidx``: (B,) int32;
    ``btab``: (256, 3, 8) and ``qtab``: (npad, 256, 3, 8) uint32.  A lane
    whose key index lies outside the stack fails."""
    c = curve(s.device)
    f = c.fp
    s, h, rx, ry = (bytes_to_limbs(a) for a in (s, h, rx, ry))
    rxm, rym = grp(f.mul, [(rx, f.R2), (ry, f.R2)])
    r_on = is_on_curve(c, rxm, rym)
    b = words_to_limbs(btab).unbind(-2)  # X, Y, T: 3 x (256, 16)
    q = words_to_limbs(qtab).unbind(-2)  # 3 x (npad, 256, 16)
    kidx = kidx.to(torch.int64)
    in_stack = (kidx >= 0) & (kidx < qtab.shape[0])
    k = kidx.clamp(0, max(qtab.shape[0] - 1, 0))
    ds, dh = comb_digits(s), comb_digits(h)
    one = f.one.expand_as(s)
    acc = tuple(v.expand_as(s) for v in c.ident)
    for i in range(STRIDE):
        acc = point_double(f, acc)
        bx, by, bt = (t[ds[:, i]] for t in b)
        acc = point_add(f, c.d2_m, acc, (bx, by, one, bt))
        qx, qy, qt = (t[k, dh[:, i]] for t in q)
        acc = point_add(f, c.d2_m, acc, (qx, qy, one, qt))
    x, y, z, _ = acc
    # Z != 0: a zero (padding) table entry drives the accumulator to the
    # all-zero point, which the comparison below would match on every lane
    mx, my = grp(f.mul, [(rxm, z), (rym, z)])
    match = eq(mx, x) & eq(my, y) & ~is_zero(z)
    mask = match & r_on & (ok != 0) & in_stack
    return mask.to(torch.int32)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib(name: str = "cuda_ed25519"):
    """The kernel library the wrapper loads, or a build of the same source
    with another group size (a name in :data:`csrc.VARIANTS`)."""
    lib = csrc.load(name)
    vp = ctypes.c_void_p
    lib.smartbft_ed_comb_verify.restype = ctypes.c_int
    lib.smartbft_ed_comb_verify.argtypes = [vp] * 8 + [ctypes.c_int, vp,
                                                       ctypes.c_int, vp]
    lib.smartbft_ed_comb_group.restype = ctypes.c_int
    lib.smartbft_ed_comb_group.argtypes = []
    return lib


def group_size(name: str = "cuda_ed25519") -> int:
    """Threads per signature of the kernel library ``name``."""
    return _lib(name).smartbft_ed_comb_group()


def launch(lib: str, s, h, rx, ry, ok, kidx, btab, qtab) -> torch.Tensor:
    """Check the CUDA tensors (shapes as the plain version's), then launch
    the kernel of the library ``lib`` (see :func:`_lib`); counts nothing."""
    bsz, dev = s.shape[0], s.device
    for a, name in zip((s, h, rx, ry), ("s", "h", "rx", "ry")):
        _check_bytes(a, name, bsz, dev)
    check_lanes(ok, "ok", bsz, dev)
    check_lanes(kidx, "kidx", bsz, dev)
    for t, name, shape in ((btab, "btab", (TSIZE, 3, 8)),
                           (qtab, "qtab", (qtab.shape[0], TSIZE, 3, 8))):
        if t.dtype != torch.uint32 or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape} uint32 "
                             f"on {dev}, got {tuple(t.shape)} {t.dtype}")
    out = torch.empty(bsz, dtype=torch.int32, device=dev)
    if bsz == 0:
        return out
    # the launch goes to the current device: make it the tensors'
    # (a worker thread starts on device 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib(lib).smartbft_ed_comb_verify(
            s.data_ptr(), h.data_ptr(), rx.data_ptr(), ry.data_ptr(),
            ok.data_ptr(), kidx.data_ptr(), btab.data_ptr(), qtab.data_ptr(),
            qtab.shape[0], out.data_ptr(), bsz, stream)
    csrc.check(rc, "ed_comb_verify")
    return out


def eddsa_verify_comb_cuda(s, h, rx, ry, ok, kidx, btab, qtab) -> torch.Tensor:
    """Launch the comb kernel on CUDA tensors (shapes as the plain one)."""
    out = launch("cuda_ed25519", s, h, rx, ry, ok, kidx, btab, qtab)
    if out.numel():
        LAUNCHES.add(out.numel())
    return out


def eddsa_verify_comb(s, h, rx, ry, ok, kidx, btab, qtab) -> torch.Tensor:
    """Batched Ed25519 verify against registered keys; (B,) int32 0/1
    mask.  CUDA inputs run the kernel, CPU inputs the plain version.
    Lanes with ok = 0 (padding, host rejections) fail."""
    args = [as_tensor(a) for a in (s, h, rx, ry, ok, kidx, btab, qtab)]
    if args[0].is_cuda:
        return eddsa_verify_comb_cuda(*args)
    return eddsa_verify_comb_plain(*args)


def mont_ops(s, h, rx, ry, ok, kidx, btab, qtab) -> dict:
    """Products and squarings mod p the batch needs (:mod:`.opcount`).  A
    lane with ``ok = 0`` or a key index outside the stack needs none.  Any
    other needs R's curve check (2 squarings + 2 products); on the curve,
    the comb walk over affine table entries and the comparison (2 products
    where Z is not 1).  No Montgomery conversion is counted: a reduction
    for 2^255 - 19 needs none."""
    ok, kidx = lane_array(ok), lane_array(kidx)
    live = (ok != 0) & (kidx >= 0) & (kidx < qtab.shape[0])
    on = on_curve_lanes(rx, ry)
    ds, dh = (comb_digits(bytes_to_limbs(as_tensor(a).cpu())).numpy()
              for a in (s, h))
    mul, sqr, acc = walk_ops(comb_walk(ds, dh), len(ok), EDWARDS)
    mul += 2 * (acc == PROJ)
    walk = live & on
    return {"ed_mul": int((2 * live + walk * mul).sum()),
            "ed_sqr": int((2 * live + walk * sqr).sum())}


# ---------------------------------------------------------------------------
# engine adapter
# ---------------------------------------------------------------------------


class Ed25519CombVerifier(CombVerifier):
    """Engine adapter: the Edwards hooks on CombVerifier's scaffolding."""

    def _make_registry(self, cap: int) -> CombKeyRegistry:
        return CombKeyRegistry(cap=cap, validate=_validate_pub,
                               build=_build_key_table)

    def _base_table(self) -> np.ndarray:
        return b_table()

    def _pack(self, items):
        s8, h8, rx8, ry8, ok, kidx = pack_items(items, self.registry)
        return [s8, h8, rx8, ry8], ok, kidx

    def _launch(self, arrays, ok, kidx, btab, qtab):
        return eddsa_verify_comb(*arrays, ok, kidx, btab, qtab)
