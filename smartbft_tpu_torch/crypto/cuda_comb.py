"""Static-key comb P-256 verify: tables, registry, the CUDA kernel and its
plain-torch version.

Port of the TPU kernel ``smartbft_tpu/crypto/pallas_comb.py`` (``_kernel``,
driven by ``ecdsa_verify_comb``).  In a BFT deployment both bases of
u1·G + u2·Q are static: G is the generator and Q one of n replica keys
fixed at configuration time.  The host precomputes, once per key, a
Lim–Lee comb table (8 teeth, stride 32) of 256 entries T[idx] =
Σ_t bit_t(idx)·2^(32t)·K, so a verify is 32 × (one complete doubling +
two complete additions) instead of 128 Strauss–Shamir digits.  Keys are
validated on-curve once, at registration.

On Hopper a table lookup is a direct load ``gtab[digit]`` /
``qtab[kidx][digit]`` from global memory (the tables stay in L2); the TPU
kernel's split-byte bf16 rows and one-hot matmul select are not carried
over.  Tables are uint32 Montgomery words shaped ``(npad, 256, 3, 8)``,
entry 0 the projective identity (0 : 1 : 0).

* :func:`ecdsa_verify_comb` is the wrapper: CUDA tensors launch
  ``csrc/cuda_comb.cu`` (a group of 8 threads per signature over the stage
  program of ``csrc/p256_comb_group.cuh``, counted in :data:`LAUNCHES`),
  CPU tensors run :func:`ecdsa_verify_comb_plain`; there is no fallback
  between them.
* :class:`CombKeyRegistry` and :class:`CombVerifier` are the engine side:
  registration, power-of-two stacking, the registry-full warning, and a
  device-table cache keyed on the registry version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import threading

import numpy as np
import torch

from .. import csrc
from . import p256
from .bignum import bytes_to_limbs, words_to_limbs
from .cuda_ecdsa import (
    N_OPS,
    _bits,
    _check_bytes,
    as_tensor,
    curve,
    final_ops,
    point_add,
    point_double,
    scalars_needed,
    verify_final,
    verify_scalars,
)
from .opcount import WEIERSTRASS, comb_walk, lane_array, lane_bytes, walk_ops
from .p256 import B as CURVE_B, FP, GX, GY, P

#: comb teeth (bits per table index) and stride (scan iterations)
TEETH = 8
STRIDE = 32  # = 256 / TEETH
TSIZE = 1 << TEETH  # 256 table entries per key

#: launches and lanes of the CUDA kernel
LAUNCHES = csrc.LaunchCounter("comb_verify")


# ---------------------------------------------------------------------------
# host-side table precomputation (Python ints; once per key per process)
# ---------------------------------------------------------------------------


def is_on_curve_int(pub) -> bool:
    """Host check y² = x³ - 3x + b (mod p) for an affine public key."""
    x, y = pub
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - (x * x * x - 3 * x + CURVE_B)) % P == 0


def _comb_entries(point) -> list:
    """All 2^TEETH subset sums of {2^(STRIDE·t)·point : t < TEETH}."""
    bases = [point]
    for _ in range(TEETH - 1):
        b = bases[-1]
        for _ in range(STRIDE):
            b = p256._point_add_int(b, b)
        bases.append(b)
    table = [None] * TSIZE
    for idx in range(1, TSIZE):
        low = idx & -idx
        table[idx] = p256._point_add_int(table[idx ^ low], bases[low.bit_length() - 1])
    return table


def build_table(pub) -> np.ndarray:
    """(256, 3, 8) uint32 comb table for one affine point: entry idx holds
    (X, Y, Z) in Montgomery words, the identity as (0 : 1 : 0), which the
    complete formulas absorb without masking."""
    out = np.zeros((TSIZE, 3, 8), np.uint32)
    one_m = FP.encode_words(1)
    for idx, ent in enumerate(_comb_entries(pub)):
        if ent is None:
            out[idx, 1] = one_m
        else:
            out[idx] = (FP.encode_words(ent[0]), FP.encode_words(ent[1]), one_m)
    return out


@functools.lru_cache(maxsize=1)
def g_table() -> np.ndarray:
    """The generator's comb table (shared by every verification)."""
    return build_table((GX, GY))


def from_jax_tables(gtab_f32, qstack_f32):
    """Carry comb tables over from the JAX package's split-byte layout.

    ``gtab_f32``: (96, 256) and ``qstack_f32``: (npad·96, 256) float32, rows
    [0:48] the low and [48:96] the high bytes of the 16-bit Montgomery limbs
    of (X, Y, Z), one column per entry.  Returns ((256, 3, 8),
    (npad, 256, 3, 8)) uint32 tables in this module's layout."""

    def convert(t):
        t = np.asarray(t, np.float32)
        limbs = t[:48].astype(np.uint32) + (t[48:].astype(np.uint32) << 8)
        limbs = limbs.T.reshape(TSIZE, 3, 8, 2)  # 16-bit limbs, lo first
        return limbs[..., 0] | (limbs[..., 1] << 16)

    gq = np.asarray(qstack_f32)
    if gq.shape[0] % 96:
        raise ValueError("qstack row count must be a multiple of 96")
    q = [convert(gq[i * 96:(i + 1) * 96]) for i in range(gq.shape[0] // 96)]
    return convert(gtab_f32), np.stack(q) if q else np.zeros(
        (0, TSIZE, 3, 8), np.uint32)


def pack_items(items, registry) -> tuple:
    """items -> ((B,32) uint8 e/r/s little-endian, (B,) int32 kidx).

    96 bytes a signature, from C-speed ``int.to_bytes`` + ``frombuffer``.
    Raises ValueError via the registry for unregistrable keys."""
    B = len(items)
    e8 = np.empty((B, 32), np.uint8)
    r8 = np.empty((B, 32), np.uint8)
    s8 = np.empty((B, 32), np.uint8)
    kidx = np.empty(B, np.int32)
    for i, (msg, r, s, pub) in enumerate(items):
        e8[i] = np.frombuffer(hashlib.sha256(msg).digest()[::-1], np.uint8)
        r8[i] = np.frombuffer(r.to_bytes(32, "little"), np.uint8)
        s8[i] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
        kidx[i] = registry.register(pub)
    return e8, r8, s8, kidx


# ---------------------------------------------------------------------------
# the plain-torch version
# ---------------------------------------------------------------------------


def comb_digits(u) -> torch.Tensor:
    """(B, 16) limbs -> (B, 32) comb indices, MSB-first: column k reads
    bits {c + 32·t : t < 8} of u with c = 31 - k, bit t of the index."""
    teeth = _bits(u).unflatten(-1, (TEETH, STRIDE))  # [t, c]
    sh = torch.arange(TEETH, device=u.device)[:, None]
    return (teeth << sh).sum(-2).flip(-1)


def ecdsa_verify_comb_plain(e, r, s, kidx, gtab, qtab) -> torch.Tensor:
    """The comb verify in plain torch; (B,) int32 mask on the inputs'
    device.  ``e, r, s``: (B, 32) uint8; ``kidx``: (B,) int32; ``gtab``:
    (256, 3, 8) and ``qtab``: (npad, 256, 3, 8) uint32.  A lane whose key
    index lies outside the stack fails."""
    c = curve(e.device)
    fp, b_m = c.fp, c.b_m
    e, r, s = (bytes_to_limbs(a) for a in (e, r, s))
    u1, u2, ok = verify_scalars(c, e, r, s)
    g = words_to_limbs(gtab).unbind(-2)  # 3 x (256, 16)
    q = words_to_limbs(qtab).unbind(-2)  # 3 x (npad, 256, 16)
    kidx = kidx.to(torch.int64)
    in_stack = (kidx >= 0) & (kidx < qtab.shape[0])
    k = kidx.clamp(0, max(qtab.shape[0] - 1, 0))
    dg, dq = comb_digits(u1), comb_digits(u2)
    acc = tuple(v.expand_as(e) for v in c.inf)
    for i in range(STRIDE):
        acc = point_double(fp, b_m, acc)
        acc = point_add(fp, b_m, acc, tuple(t[dg[:, i]] for t in g))
        acc = point_add(fp, b_m, acc, tuple(t[k, dq[:, i]] for t in q))
    mask = verify_final(c, acc, r) & ok & in_stack
    return mask.to(torch.int32)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib(name: str = "cuda_comb"):
    """The kernel library the wrapper loads, or a build of the same source
    with another group size (a name in :data:`csrc.VARIANTS`)."""
    lib = csrc.load(name)
    vp = ctypes.c_void_p
    lib.smartbft_comb_verify.restype = ctypes.c_int
    lib.smartbft_comb_verify.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_int,
                                         vp, ctypes.c_int, vp]
    lib.smartbft_comb_group.restype = ctypes.c_int
    lib.smartbft_comb_group.argtypes = []
    return lib


def group_size(name: str = "cuda_comb") -> int:
    """Threads per signature of the kernel library ``name``."""
    return _lib(name).smartbft_comb_group()


def launch(lib: str, e, r, s, kidx, gtab, qtab) -> torch.Tensor:
    """Check the CUDA tensors (shapes as the plain version's), then launch
    the kernel of the library ``lib`` (see :func:`_lib`); counts nothing."""
    bsz, dev = e.shape[0], e.device
    for a, name in zip((e, r, s), ("e", "r", "s")):
        _check_bytes(a, name, bsz, dev)
    if kidx.dtype != torch.int32 or tuple(kidx.shape) != (bsz,) \
            or kidx.device != dev:
        raise ValueError(f"kidx: expected ({bsz},) int32 on {dev}")
    for t, name, shape in ((gtab, "gtab", (TSIZE, 3, 8)),
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
        rc = _lib(lib).smartbft_comb_verify(
            e.data_ptr(), r.data_ptr(), s.data_ptr(), kidx.data_ptr(),
            gtab.data_ptr(), qtab.data_ptr(), qtab.shape[0], out.data_ptr(),
            bsz, stream)
    csrc.check(rc, "comb_verify")
    return out


def ecdsa_verify_comb_cuda(e, r, s, kidx, gtab, qtab) -> torch.Tensor:
    """Launch the comb kernel on CUDA tensors (shapes as the plain one)."""
    out = launch("cuda_comb", e, r, s, kidx, gtab, qtab)
    if out.numel():
        LAUNCHES.add(out.numel())
    return out


def ecdsa_verify_comb(e, r, s, kidx, gtab, qtab) -> torch.Tensor:
    """Batched P-256 verify against registered keys; (B,) int32 0/1 mask.
    CUDA inputs run the kernel, CPU inputs the plain version.  Zero lanes
    (r = s = 0) always fail."""
    args = [as_tensor(a) for a in (e, r, s, kidx, gtab, qtab)]
    if args[0].is_cuda:
        return ecdsa_verify_comb_cuda(*args)
    return ecdsa_verify_comb_plain(*args)


def mont_ops(e, r, s, kidx, gtab, qtab) -> dict:
    """Products and squarings by modulus the batch needs (:mod:`.opcount`).
    A lane failing its range checks or with a key index outside the stack
    needs none.  Any other needs the scalar work (:data:`~.cuda_ecdsa.N_OPS`),
    the comb walk over affine table entries and the comparison."""
    ok, u1, u2 = scalars_needed(e, r, s)
    kidx = lane_array(kidx)
    live = ok & (kidx >= 0) & (kidx < qtab.shape[0])
    d1, d2 = (comb_digits(bytes_to_limbs(torch.from_numpy(
        lane_bytes(u)))).numpy() for u in (u1, u2))
    mul, sqr, acc = walk_ops(comb_walk(d1, d2), len(kidx), WEIERSTRASS)
    mul += final_ops(acc, r)
    n = int(live.sum())
    return {"n_mul": n * N_OPS["n_mul"], "n_sqr": n * N_OPS["n_sqr"],
            "p_mul": int((live * mul).sum()), "p_sqr": int((live * sqr).sum())}


# ---------------------------------------------------------------------------
# key registry + engine adapter
# ---------------------------------------------------------------------------


class CombRegistryFull(ValueError):
    """The registry's key cap was reached — NOT an invalid key.

    A full registry only means the comb path can't serve the extra keys
    (the generic kernel still verifies them), whereas an invalid key is a
    configuration error worth failing loudly over."""


def _p256_validate(pub):
    if not is_on_curve_int(pub):
        raise ValueError("public key is not on the P-256 curve")


class CombKeyRegistry:
    """pub -> table index; tables built once per key, stacked and padded.

    Scheme-agnostic: ``validate``/``build`` default to the P-256 curve
    check and comb builder; :mod:`.cuda_ed25519` gives the Edwards ones.
    An entry is 3 x 8 words for either curve ((X, Y, Z) for P-256, (X, Y,
    T) for Ed25519).  The stack is padded
    to a power-of-two key count so the device copy is rebuilt at most
    log2(cap) times as membership grows.  Padding tables are zero, so a
    reference to a padded index adds the all-zero point and fails the
    verify, never accepts."""

    def __init__(self, cap: int = 128, validate=None, build=None):
        self.cap = cap
        #: raises ValueError for a key the scheme cannot register
        self.validate = validate if validate is not None else _p256_validate
        self._build = build if build is not None else build_table
        self._index: dict = {}
        self._tables: list[np.ndarray] = []
        self._stack: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self._tables)

    def register(self, pub) -> int:
        """Index for ``pub`` (validating + building its table on first use).

        Raises ValueError for invalid keys or when the cap is exceeded."""
        idx = self._index.get(pub)
        if idx is not None:
            return idx
        if len(self._tables) >= self.cap:
            raise CombRegistryFull(f"comb key registry full ({self.cap})")
        self.validate(pub)
        idx = len(self._tables)
        self._index[pub] = idx
        self._tables.append(self._build(pub))
        self._stack = None
        return idx

    def index_of(self, pub):
        """Registered index or None (no side effects)."""
        return self._index.get(pub)

    def stacked(self) -> np.ndarray:
        """(npad, 256, 3, 8) uint32 stack, npad = next power of two."""
        if self._stack is None:
            npad = 1
            while npad < len(self._tables):
                npad *= 2
            stack = np.zeros((npad, TSIZE, 3, 8), np.uint32)
            for i, t in enumerate(self._tables):
                stack[i] = t
            self._stack = stack
        return self._stack


class CombVerifier:
    """Engine adapter: items -> comb-kernel launch with cached device tables.

    ``verify(items, pad_to)`` returns a (len(items),) mask tensor, or None
    when any item's key is unregistrable (the caller routes the chunk to
    the generic kernel).  The prewarm / device-table caching / pad-and-
    launch scaffolding is scheme-agnostic; a scheme overrides the four
    ``_...`` hooks (:class:`.cuda_ed25519.Ed25519CombVerifier`)."""

    def __init__(self, device, cap: int = 128):
        self.device = torch.device(device)
        self.registry = self._make_registry(cap)
        self._pending_prewarm: list = []
        self._dev_version: int = -1
        self._dev_gtab = None
        self._dev_qtab = None
        # engines overlap flushes on worker threads, so concurrent verify()
        # calls can race first-use registration: all registry / prewarm /
        # device-table mutation happens under this lock; only the packing
        # and the launch run outside it
        self._reg_lock = threading.RLock()
        self._warned_full = False

    # -- scheme hooks (P-256 defaults) --------------------------------------

    def _make_registry(self, cap: int) -> CombKeyRegistry:
        return CombKeyRegistry(cap=cap)

    def _base_table(self) -> np.ndarray:
        return g_table()

    def _pack(self, items):
        """items -> ([(B, 32) uint8 arrays...], (B,) int32 ok or None,
        (B,) int32 kidx)."""
        e8, r8, s8, kidx = pack_items(items, self.registry)
        return [e8, r8, s8], None, kidx

    def _launch(self, arrays, ok, kidx, gtab, qtab):
        """One launch on the device tensors; ``ok`` is None for P-256."""
        return ecdsa_verify_comb(*arrays, kidx, gtab, qtab)

    # -- shared scaffolding --------------------------------------------------

    def prewarm_keys(self, pubs) -> None:
        """Record a known key set (e.g. the whole keyring) to register
        before the first verify.  Validation is EAGER (an invalid key raises
        here); table building is deferred to the first verify.  If the set
        exceeds the remaining capacity, the fitting prefix is still queued
        and CombRegistryFull reports the overflow."""
        pubs = list(pubs)
        for pub in pubs:
            self.registry.validate(pub)
        with self._reg_lock:
            known = set(self.registry._index) | set(self._pending_prewarm)
            room = self.registry.cap - len(known)
            fitting, overflow = [], 0
            for pub in pubs:
                if pub in known:
                    continue
                if len(fitting) < room:
                    fitting.append(pub)
                    known.add(pub)
                else:
                    overflow += 1
            self._pending_prewarm.extend(fitting)
            if overflow:
                raise CombRegistryFull(
                    f"comb key registry full ({self.registry.cap}): "
                    f"{overflow} key(s) beyond capacity "
                    f"({len(fitting)} queued)")

    def _warn_registry_full(self, exc) -> None:
        """Warn ONCE per verifier when registration hits a full registry:
        chunks with unregistrable keys riding the generic kernel would
        otherwise hide the fast path dying."""
        if not self._warned_full:
            self._warned_full = True
            logging.getLogger("smartbft_tpu_torch.crypto").warning(
                "comb key registry full at verify time; chunks with "
                "unregistered keys go to the generic verify kernel: %s", exc,
            )

    def device_tables(self):
        """(gtab, qtab) on the device, re-uploaded when the registry grew."""
        version = len(self.registry)
        if version != self._dev_version:
            self._dev_gtab = torch.from_numpy(
                self._base_table()).to(self.device)
            self._dev_qtab = torch.from_numpy(
                self.registry.stacked()).to(self.device)
            self._dev_version = version
        return self._dev_gtab, self._dev_qtab

    def verify(self, items, pad_to: int):
        chunk_pubs = {it[-1] for it in items}
        with self._reg_lock:
            if self._pending_prewarm:
                pending, self._pending_prewarm = self._pending_prewarm, []
                try:
                    for pub in pending:
                        self.registry.register(pub)
                except CombRegistryFull as exc:
                    self._warn_registry_full(exc)
            try:
                # O(distinct signers) lock-held work, not O(items)
                for pub in chunk_pubs:
                    self.registry.register(pub)
            except CombRegistryFull as exc:
                # the WHOLE chunk goes to the generic kernel (splitting the
                # launch would double the fixed per-launch cost)
                self._warn_registry_full(exc)
                return None
            except ValueError:
                return None  # invalid key: generic kernel
            gtab, qtab = self.device_tables()
        # every key is registered now: _pack's register calls are dict hits,
        # no shared-state mutation outside the lock
        arrays, ok, kidx = self._pack(items)
        n = len(items)
        if pad_to > n:
            z = np.zeros((pad_to - n, 32), np.uint8)
            arrays = [np.concatenate([a, z]) for a in arrays]
            lanes = np.zeros(pad_to - n, np.int32)
            if ok is not None:
                ok = np.concatenate([ok, lanes])
            kidx = np.concatenate([kidx, lanes])

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        mask = self._launch([dev(a) for a in arrays],
                            None if ok is None else dev(ok), dev(kidx),
                            gtab, qtab)
        return mask[:n]
