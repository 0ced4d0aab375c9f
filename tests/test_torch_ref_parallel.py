"""The reference's parallel-plane cases against the port:
``tests/test_parallel.py``, compiled against ``smartbft_tpu_torch`` by
:mod:`torch_reference`, on 8 virtual CPU devices (``torchenv.force_cpu``),
under an exact count guard.

Left out: the two ``quorum_decide`` cases, whose helper places the block
with ``jax.device_put`` and a ``NamedSharding``.  Their counterparts below
hand the port's ``quorum_decide`` the scheme's generic-route inputs
(``p256.verify_bytes``, ``ed25519.verify_inputs``), as host arrays, on a
(1, 2) mesh: the smallest one with a vote axis to sum over, since each
tile runs the generic kernel's plain version, seconds a launch here.
"""

from smartbft_tpu_torch.crypto import ed25519 as ed
from smartbft_tpu_torch.crypto import p256
from smartbft_tpu_torch.parallel import build_mesh, quorum_decide
from torch_reference import check_matrices, reference_tests, virtual_devices

_virtual_devices = virtual_devices(8)

LEAVE_OUT = {
    "test_quorum_decide_2d_mesh":
        "places the block with jax.device_put and a NamedSharding",
    "test_quorum_decide_scheme_generic_ed25519":
        "places the block with jax.device_put and a NamedSharding",
}
CASES = {"test_parallel.py": 4}
LEFT_OUT = {"test_parallel.py": sorted(LEAVE_OUT)}

globals().update(reference_tests("test_parallel.py", leave_out=LEAVE_OUT))


def test_reference_cases_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT, leave_out=LEAVE_OUT)


def test_quorum_decide_2d_mesh():
    """``test_quorum_decide_2d_mesh``: 4 sequences of 4 P-256 votes,
    sequence 2 with only 2 valid ones, quorum 3."""
    mesh = build_mesh((1, 2), ("seq", "vote"))
    n_seq, n_votes = 4, 4
    keys = [p256.keygen(b"q-%d" % v) for v in range(n_votes)]
    items = []
    for s in range(n_seq):
        msg = b"prop-%d" % s
        for v, (d, pub) in enumerate(keys):
            _, r, sg, _ = p256.make_item(msg, p256.sign_raw(d, msg), pub)
            if s == 2 and v >= 2:
                r ^= 1
            items.append((msg, r, sg, pub))
    args = tuple(a.reshape((n_seq, n_votes, 32))
                 for a in p256.verify_bytes(items))
    decided = quorum_decide(mesh, 3)(*args)
    assert decided.tolist() == [True, True, False, True]


def test_quorum_decide_scheme_generic_ed25519():
    """``test_quorum_decide_scheme_generic_ed25519``: Ed25519's host
    validity flag is a rank-2 input beside the rank-3 byte arrays."""
    mesh = build_mesh((1, 2), ("seq", "vote"))
    n_seq, n_votes = 2, 2
    keys = [ed.keygen(b"edq-%d" % v) for v in range(n_votes)]
    items = []
    for s in range(n_seq):
        msg = b"prop-%d" % s
        for sk, pub in keys:
            items.append((msg, ed.sign(sk, msg), pub))
    args = tuple(a.reshape((n_seq, n_votes) + a.shape[1:])
                 for a in ed.verify_inputs(items))
    assert sorted({a.ndim for a in args}) == [2, 3]
    decided = quorum_decide(mesh, 2, scheme=ed)(*args)
    assert decided.tolist() == [True, True]
