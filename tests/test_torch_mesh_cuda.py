"""The mesh engines on the cards, against the single-device engine on the
same inputs, verdicts bit for bit.  Marked ``gpu``: they need an NVIDIA
Hopper card and nvcc, and skip elsewhere (decided in the fixture).

Run on the card:  python3 -m pytest -q --noconftest -m gpu tests/test_torch_mesh_cuda.py
"""

import pytest
import torch

from smartbft_tpu_torch.crypto import cuda_comb as cc
from smartbft_tpu_torch.crypto import cuda_ecdsa as ce
from smartbft_tpu_torch.crypto import p256
from smartbft_tpu_torch.crypto.provider import TorchVerifyEngine
from smartbft_tpu_torch.parallel import (
    MeshVerifyEngine,
    QuorumMeshVerifyEngine,
    mesh_device_count,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the kernels run only on the card")
    from smartbft_tpu_torch import csrc

    try:
        csrc.nvcc_path()
    except csrc.KernelBuildError as exc:
        pytest.skip(str(exc))
    return torch.cuda.device_count()


def _wave(n=23):
    """3 signers, forged votes, a key off the curve (the generic route),
    messages shared by signers (quorum rows)."""
    keys = [p256.keygen(b"mesh-gpu-%d" % t) for t in range(3)]
    items = []
    for i in range(n):
        sk, pub = keys[i % 3]
        msg = b"mesh-gpu-msg-%d" % (i % 5)
        sig = p256.sign_raw(sk, msg)
        if i % 4 == 3:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(p256.make_item(msg, sig, pub))
    m, r, s, (qx, qy) = items[7]
    items[7] = (m, r, s, (qx, (qy + 1) % p256.P))
    return items


def _tally(items, verdicts):
    tally, seen = {}, set()
    for it, ok in zip(items, verdicts):
        tally.setdefault(it[0], 0)
        if ok and it not in seen:
            tally[it[0]] += 1
        seen.add(it)
    return tally


def _check_engines(devices):
    items = _wave()
    want = TorchVerifyEngine(device="cuda", pad_sizes=(32,)).verify(items)
    assert want == [p256.verify_item(it) for it in items]
    mesh = MeshVerifyEngine(devices=devices, pad_sizes=(32,))
    quorum = QuorumMeshVerifyEngine(devices=devices, quorum=2)
    before = cc.LAUNCHES.launches + ce.LAUNCHES.launches
    assert mesh.verify(items) == want
    assert sum(mesh.route_launches.values()) == devices
    assert quorum.verify(items) == want
    assert quorum.last_counts == _tally(items, want)
    assert quorum.last_decided == {m: c >= 2 for m, c
                                   in _tally(items, want).items()}
    assert cc.LAUNCHES.launches + ce.LAUNCHES.launches - before \
        == devices * (1 + quorum.psum_steps)
    return mesh, quorum


def test_mesh_engines_on_every_card_match_the_single_device_engine(cards):
    assert mesh_device_count() == cards
    mesh, quorum = _check_engines(cards)
    assert [c.device for c in mesh._combs] == [
        torch.device("cuda", i) for i in range(cards)]


def test_mesh_of_two_cards_launches_each_tile_on_its_card(cards):
    """Each card's tile launches on that card, from a thread whose
    current device is another one (as the coalescer's workers are)."""
    if cards < 2:
        pytest.skip(f"{cards} CUDA card(s) visible: a mesh across cards "
                    "needs at least 2")
    torch.cuda.set_device(1)
    try:
        mesh, _ = _check_engines(2)
    finally:
        torch.cuda.set_device(0)
    assert mesh.stats.last_device_fill_pct[1] > 0
