"""The CUDA kernels on the card, each against its plain-torch version on
the same inputs, mask bit for bit.  Marked ``gpu``: they need an NVIDIA
Hopper card and nvcc, and skip elsewhere (decided in the fixture).

Run on the card:  python3 -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from smartbft_tpu_torch.crypto import bls12381 as bls
from smartbft_tpu_torch.crypto import cuda_bls as cbl
from smartbft_tpu_torch.crypto import cuda_comb as cc
from smartbft_tpu_torch.crypto import cuda_ecdsa as ce
from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
from smartbft_tpu_torch.crypto import cuda_eddsa as cgd
from smartbft_tpu_torch.crypto import ed25519 as ed
from smartbft_tpu_torch.crypto import p256
from smartbft_tpu_torch.crypto.provider import TorchVerifyEngine

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the kernels run only on the card")
    from smartbft_tpu_torch import csrc

    try:
        csrc.nvcc_path()
    except csrc.KernelBuildError as exc:
        pytest.skip(str(exc))
    return torch.device("cuda")


def _items(n, keys, tag):
    items = []
    for i in range(n):
        d, pub = keys[i % len(keys)]
        msg = f"{tag}-{i}".encode()
        items.append(p256.make_item(msg, p256.sign_raw(d, msg), pub))
    m, r, s, pub = items[1]
    items[1] = (m, (r + 1) % p256.N, s, pub)
    m, r, s, pub = items[2]
    items[2] = (m, 0, s, pub)
    m, r, s, pub = items[3]
    items[3] = (m, r, p256.N, pub)
    return items


@pytest.mark.parametrize("bsz", [1, 17, 130, 509, 2048])
def test_comb_kernel_matches_plain(cuda, bsz):
    """Ragged batches too: the kernel verifies 32 signatures a block, and
    the signatures past the batch must neither store nor stall a group."""
    keys = [p256.keygen(b"gpu-%d" % i) for i in range(8)]
    items = _items(max(bsz, 4), keys, "comb")[:bsz]
    reg = cc.CombKeyRegistry()
    e8, r8, s8, kidx = cc.pack_items(items, reg)
    if bsz > 4:
        kidx[4] = (kidx[4] + 1) % 8
    args = [torch.from_numpy(a).to(cuda) for a in (e8, r8, s8, kidx)]
    tables = [torch.from_numpy(cc.g_table()).to(cuda),
              torch.from_numpy(reg.stacked()).to(cuda)]
    before = cc.LAUNCHES.launches
    got = cc.ecdsa_verify_comb(*args, *tables)
    assert cc.LAUNCHES.launches == before + 1
    want = cc.ecdsa_verify_comb_plain(*args, *tables)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bsz", [17, 509])
def test_comb_group_variant_matches_plain(cuda, bsz):
    """The build at 4 threads a signature (csrc.VARIANTS) gives the plain
    version's mask; the library the wrapper loads runs 8."""
    keys = [p256.keygen(b"gpu-cv-%d" % i) for i in range(3)]
    items = _items(bsz, keys, "combv")
    reg = cc.CombKeyRegistry()
    e8, r8, s8, kidx = cc.pack_items(items, reg)
    kidx[4] = (kidx[4] + 1) % 3
    args = [torch.from_numpy(a).to(cuda) for a in (e8, r8, s8, kidx)] + \
        [torch.from_numpy(cc.g_table()).to(cuda),
         torch.from_numpy(reg.stacked()).to(cuda)]
    assert (cc.group_size(), cc.group_size("cuda_comb_g4")) == (8, 4)
    before = cc.LAUNCHES.launches
    got = cc.launch("cuda_comb_g4", *args)
    assert cc.LAUNCHES.launches == before
    assert torch.equal(got, cc.ecdsa_verify_comb_plain(*args))
    expect = [int(p256.verify_item(it)) for it in items]
    expect[4] = 0
    assert got.cpu().tolist() == expect


@pytest.mark.parametrize("bsz", [1, 33, 130, 509])
def test_generic_kernel_matches_plain(cuda, bsz):
    """Ragged batches too: the kernel verifies 16 signatures a block, and
    the signatures past the batch must neither store nor stall a group."""
    keys = [p256.keygen(b"gpu-g-%d" % i) for i in range(4)]
    items = _items(max(bsz, 4), keys, "gen")[:bsz]
    if bsz > 5:
        m, r, s, (x, y) = items[5]
        items[5] = (m, r, s, (x, (y + 1) % p256.P))  # off-curve key
    arrays = [torch.from_numpy(a).to(cuda) for a in p256.verify_bytes(items)]
    before = ce.LAUNCHES.launches
    got = ce.ecdsa_verify(*arrays)
    assert ce.LAUNCHES.launches == before + 1
    assert torch.equal(got, ce.ecdsa_verify_plain(*arrays))
    assert got.cpu().tolist() == [int(p256.verify_item(it)) for it in items]


def test_engine_on_the_card(cuda):
    ring_keys = [p256.keygen(b"gpu-e-%d" % i) for i in range(4)]
    eng = TorchVerifyEngine()
    items = _items(8, ring_keys, "eng")
    assert eng.verify(items) == [p256.verify_item(it) for it in items]
    assert eng.route_launches["comb"] == 1


def test_launcher_rejects_cpu_tables(cuda):
    e = torch.zeros((2, 32), dtype=torch.uint8, device=cuda)
    kidx = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cc.ecdsa_verify_comb_cuda(e, e, e, kidx,
                                  torch.from_numpy(cc.g_table()),
                                  torch.from_numpy(np.zeros((1, 256, 3, 8),
                                                            np.uint32)))


def _ed_items(n, keys, tag):
    """Ed25519 votes with a corrupted S, a tampered message, S >= L and an
    undecodable R in lanes 1-4."""
    items = []
    for i in range(n):
        priv, pub = keys[i % len(keys)]
        msg = f"{tag}-{i}".encode()
        items.append(ed.make_item(msg, ed.sign_raw(priv, msg), pub))
    m, sig, pub = items[1]
    bad_s = (int.from_bytes(sig[32:], "little") + 1) % ed.L
    items[1] = (m, sig[:32] + bad_s.to_bytes(32, "little"), pub)
    m, sig, pub = items[2]
    items[2] = (b"tampered", sig, pub)
    m, sig, pub = items[3]
    items[3] = (m, sig[:32] + (ed.L + 1).to_bytes(32, "little"), pub)
    m, sig, pub = items[4]
    items[4] = (m, b"\xff" * 32 + sig[32:], pub)
    return items


@pytest.mark.parametrize("bsz", [1, 17, 130, 509, 2048])
def test_ed_comb_kernel_matches_plain(cuda, bsz):
    """Ragged batches too: the kernel verifies 16 signatures a block, and
    the signatures past the batch must neither store nor stall a group."""
    keys = [ed.keygen(b"gpu-ed-%d" % i) for i in range(5)]
    items = _ed_items(max(bsz, 8), keys, "edc")[:bsz]
    reg = ced.Ed25519CombVerifier("cpu").registry
    s8, h8, rx8, ry8, ok, kidx = ced.pack_items(items, reg)
    if bsz > 6:
        kidx[5] = (kidx[5] + 1) % 5          # wrong key claimed
        kidx[6], ok[6] = 7, 1                # a zero-padded stack slot
    args = [torch.from_numpy(a).to(cuda) for a in (s8, h8, rx8, ry8, ok, kidx)]
    tables = [torch.from_numpy(ced.b_table()).to(cuda),
              torch.from_numpy(reg.stacked()).to(cuda)]
    before = ced.LAUNCHES.launches
    got = ced.eddsa_verify_comb(*args, *tables)
    assert ced.LAUNCHES.launches == before + 1
    want = ced.eddsa_verify_comb_plain(*args, *tables)
    assert torch.equal(got, want)
    expect = [int(ed.verify_item(it)) for it in items[:8]]
    if bsz > 6:
        expect[5] = expect[6] = 0
    assert got.cpu().tolist()[:8] == expect


@pytest.mark.parametrize("bsz", [17, 509])
def test_ed_comb_group_variant_matches_plain(cuda, bsz):
    """The build at 2 threads a signature (csrc.VARIANTS) gives the plain
    version's mask, a key index outside the stack and a zero-padded slot
    among the faults; the library the wrapper loads runs 4."""
    keys = [ed.keygen(b"gpu-edcv-%d" % i) for i in range(3)]
    items = _ed_items(bsz, keys, "edcv")
    reg = ced.Ed25519CombVerifier("cpu").registry
    s8, h8, rx8, ry8, ok, kidx = ced.pack_items(items, reg)
    kidx[5] = (kidx[5] + 1) % 3          # wrong key claimed
    kidx[6], ok[6] = 3, 1                # a zero-padded stack slot
    kidx[7] = -1                         # outside the stack
    args = [torch.from_numpy(a).to(cuda)
            for a in (s8, h8, rx8, ry8, ok, kidx)] + \
        [torch.from_numpy(ced.b_table()).to(cuda),
         torch.from_numpy(reg.stacked()).to(cuda)]
    assert (ced.group_size(), ced.group_size("cuda_ed25519_g2")) == (4, 2)
    before = ced.LAUNCHES.launches
    got = ced.launch("cuda_ed25519_g2", *args)
    assert ced.LAUNCHES.launches == before
    assert torch.equal(got, ced.eddsa_verify_comb_plain(*args))
    expect = [int(ed.verify_item(it)) for it in items]
    expect[5] = expect[6] = expect[7] = 0
    assert got.cpu().tolist() == expect


@pytest.mark.parametrize("bsz", [1, 17, 130, 509])
def test_ed_generic_kernel_matches_plain(cuda, bsz):
    """Ragged batches too: the kernel verifies 16 signatures a block, and
    the signatures past the batch must neither store nor stall a group."""
    keys = [ed.keygen(b"gpu-edg-%d" % i) for i in range(3)]
    items = _ed_items(max(bsz, 8), keys, "edg")[:bsz]
    if bsz > 5:
        m, sig, _ = items[5]
        items[5] = (m, sig, b"\xff" * 32)    # undecodable public key
    arrays = [torch.from_numpy(a).to(cuda) for a in ed.verify_inputs(items)]
    before = cgd.LAUNCHES.launches
    got = cgd.eddsa_verify(*arrays)
    assert cgd.LAUNCHES.launches == before + 1
    assert torch.equal(got, cgd.eddsa_verify_plain(*arrays))
    assert got.cpu().tolist() == [int(ed.verify_item(it)) for it in items]


@pytest.mark.parametrize("bsz", [17, 509])
def test_ed_generic_group_variant_matches_plain(cuda, bsz):
    """The build at 2 threads a signature (csrc.VARIANTS) gives the plain
    version's mask; the library the wrapper loads runs 4."""
    keys = [ed.keygen(b"gpu-edv-%d" % i) for i in range(3)]
    items = _ed_items(bsz, keys, "edv")
    arrays = [torch.from_numpy(a).to(cuda) for a in ed.verify_inputs(items)]
    assert (cgd.group_size(), cgd.group_size("cuda_eddsa_g2")) == (4, 2)
    before = cgd.LAUNCHES.launches
    got = cgd.launch("cuda_eddsa_g2", *arrays)
    assert cgd.LAUNCHES.launches == before
    assert torch.equal(got, cgd.eddsa_verify_plain(*arrays))
    assert got.cpu().tolist() == [int(ed.verify_item(it)) for it in items]


def test_ed_engine_on_the_card(cuda):
    keys = [ed.keygen(b"gpu-ede-%d" % i) for i in range(4)]
    eng = TorchVerifyEngine(scheme=ed)
    items = _ed_items(8, keys, "ede")
    assert eng.verify(items) == [ed.verify_item(it) for it in items]
    assert eng.route_launches == {"comb": 1, "generic": 0}


def _bls_items():
    """Six distinct BLS lanes: two valid votes, a wrong key, a wrong
    message, an aggregated quorum and an undecodable signature."""
    keys = [bls.keygen(b"gpu-bls-%d" % i) for i in range(3)]
    msg = b"gpu-bls-digest"
    votes = [(msg, bls.sign(sk, msg), pk) for sk, pk in keys]
    return [votes[0], votes[1],
            (msg, votes[0][1], keys[1][1]),
            (b"gpu-bls-other", votes[2][1], keys[2][1]),
            bls.aggregate_items(votes),
            (msg, b"\x01" * bls.SIG_BYTES, keys[0][1])]


@pytest.mark.parametrize("bsz", [1, 17, 130])
def test_bls_kernel_matches_plain(cuda, bsz):
    """The pairing kernel against its plain version, mask bit for bit, on
    lanes cycling through the six kinds (ragged against 2 lanes a block),
    and against the host verify."""
    distinct = _bls_items()
    items = [distinct[i % len(distinct)] for i in range(bsz)]
    arrays = [torch.from_numpy(a).to(cuda) for a in cbl.verify_words(items)]
    before = cbl.LAUNCHES.launches
    got = cbl.bls_verify(*arrays)
    assert cbl.LAUNCHES.launches == before + 1
    assert torch.equal(got, cbl.bls_verify_plain(*arrays))
    truth = [int(bls.verify_item(it)) for it in distinct]
    assert truth == [1, 1, 0, 0, 1, 0]
    assert got.cpu().tolist() == [truth[i % len(distinct)] for i in range(bsz)]


def test_bls_engine_on_the_card(cuda):
    eng = TorchVerifyEngine(scheme=bls)
    items = _bls_items()
    assert eng.verify(items) == [bool(v) for v in (1, 1, 0, 0, 1, 0)]
    assert eng.route_launches == {"comb": 0, "generic": 1}
    assert eng.rung_launches == {8: 1}


@pytest.fixture(scope="module")
def bls_group_lanes():
    """Eight distinct BLS lanes for the group builds: two valid votes, a
    wrong key, a wrong message, a 43-vote aggregate (valid), the same
    aggregate one signature short, an undecodable signature (ok = 0) and
    random bytes (ok = 0); and their verdicts."""
    keys = [bls.keygen(b"gpu-blsg-%d" % i) for i in range(43)]
    msg = b"gpu-blsg-digest"
    votes = [(msg, bls.sign(sk, msg), pk) for sk, pk in keys]
    rng = np.random.default_rng(9)
    items = [votes[0], votes[1],
             (msg, votes[0][1], keys[1][1]),
             (b"gpu-blsg-other", votes[2][1], keys[2][1]),
             bls.aggregate_items(votes),
             (msg, bls.aggregate_sigs([v[1] for v in votes[1:]]),
              bls.aggregate_pubs([v[2] for v in votes])),
             (msg, b"\x01" * bls.SIG_BYTES, keys[0][1]),
             (msg, rng.bytes(bls.SIG_BYTES), rng.bytes(bls.PUB_BYTES))]
    truth = [int(bls.verify_item(it)) for it in items]
    assert truth == [1, 1, 0, 0, 1, 0, 0, 0]
    return items, truth, {}


@pytest.mark.parametrize("name", ["cuda_bls", "cuda_bls_g6"])
@pytest.mark.parametrize("bsz", [1, 5, 7, 33, 128])
def test_bls_group_builds_match_plain(cuda, bls_group_lanes, name, bsz):
    """Both group builds (12 threads a lane, the library; 6, the variant)
    against the plain version, bit for bit, at batch sizes that end inside
    a warp of 2 or 5 lanes, with ok = 0 lanes, an undecodable signature and
    a 43-vote aggregate among the lanes; the variant's launch is not
    counted."""
    items, truth, plain_by_bsz = bls_group_lanes
    lanes = [items[i % len(items)] for i in range(bsz)]
    arrays = [torch.from_numpy(a).to(cuda) for a in cbl.verify_words(lanes)]
    assert arrays[-1].cpu().tolist() == [int(i % 8 < 6) for i in range(bsz)]
    if bsz not in plain_by_bsz:
        plain_by_bsz[bsz] = cbl.bls_verify_plain(*arrays)
    assert (cbl.group_size(), cbl.group_size("cuda_bls_g6")) == (12, 6)
    before = cbl.LAUNCHES.launches
    got = cbl.launch(name, *arrays)
    assert cbl.LAUNCHES.launches == before
    assert torch.equal(got, plain_by_bsz[bsz])
    assert got.cpu().tolist() == [truth[i % len(items)] for i in range(bsz)]
