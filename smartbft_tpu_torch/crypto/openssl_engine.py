"""OpenSSL-backed verify engine: the optimized native CPU path.

The honest CPU counterpart of the card's kernels is OpenSSL through the
`cryptography` wheel: native code, not interpreted arithmetic.  This
engine is the port's CPU baseline for the benchmarks and the independent
oracle that every signature kernel's verdicts are held to.  It is not a
fallback: neither `CryptoProvider` nor `Consensus` installs it on its
own, so a caller that wants it passes it as the engine.

Supports the P-256 and Ed25519 schemes (OpenSSL has no BLS12-381; the BLS
provider's host path covers that baseline).
"""

from __future__ import annotations

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey
from cryptography.hazmat.primitives.asymmetric.utils import encode_dss_signature

from . import ed25519, p256
from .provider import HostVerifyEngine


class OpenSSLVerifyEngine(HostVerifyEngine):
    """Sequential native verification through the `cryptography` wheel.

    Same engine surface as `HostVerifyEngine` (which supplies the verify
    loop + stats bookkeeping); only the per-item backend differs.
    """

    def __init__(self, scheme=p256):
        if scheme is p256:
            self._verify_one = self._verify_p256
        elif scheme is ed25519:
            self._verify_one = self._verify_ed25519
        else:
            raise ValueError("OpenSSLVerifyEngine supports p256 and ed25519")
        super().__init__(scheme=scheme)
        self._key_cache: dict = {}

    # -- per-scheme backends -------------------------------------------------

    def _verify_p256(self, item) -> bool:
        msg, r, s, pub = item
        key = self._key_cache.get(pub)
        if key is None:
            try:
                key = ec.EllipticCurvePublicNumbers(
                    pub[0], pub[1], ec.SECP256R1()
                ).public_key()
            except ValueError:
                return False
            self._key_cache[pub] = key
        try:
            key.verify(encode_dss_signature(r, s), msg, ec.ECDSA(hashes.SHA256()))
            return True
        except (InvalidSignature, ValueError):
            return False

    def _verify_ed25519(self, item) -> bool:
        msg, sig, pub = item
        key = self._key_cache.get(pub)
        if key is None:
            try:
                key = Ed25519PublicKey.from_public_bytes(pub)
            except ValueError:
                return False
            self._key_cache[pub] = key
        try:
            key.verify(sig, msg)
            return True
        except (InvalidSignature, ValueError):
            return False
