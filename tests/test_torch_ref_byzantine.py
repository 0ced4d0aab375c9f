"""The reference's Byzantine-signature cluster cases against the port:
``tests/test_byzantine_crypto.py`` (n = 16 with f garbage signers on real
P-256 verification through one shared coalescer), compiled against
``smartbft_tpu_torch`` by :mod:`torch_reference` and collected here as
items of their own (``<file stem>__<case>``), under an exact count guard.
The reference's own ``_engine`` takes the port's OpenSSL engine."""

from torch_reference import check_matrices, reference_tests

CASES = {"test_byzantine_crypto.py": 2}
LEFT_OUT: dict = {}

for _file in CASES:
    globals().update(reference_tests(_file))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT)


def test_the_cases_verify_on_the_ports_openssl_engine():
    from smartbft_tpu_torch.crypto.openssl_engine import OpenSSLVerifyEngine

    got = reference_tests("test_byzantine_crypto.py")
    fn = next(iter(got.values()))
    engine = fn.__globals__["_engine"]()
    assert type(engine) is OpenSSLVerifyEngine
    assert type(engine).__module__ == "smartbft_tpu_torch.crypto.openssl_engine"
