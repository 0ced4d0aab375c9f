"""The pairing kernel's stage program (crypto/bls_stages.py) on its own,
with Python integers: its Fp operation count is the bound's, its stages
can run their ranks in any order, and it computes the JAX package's host
pairing value for value.  The g++ harness runs the same words through
``csrc/bls381_group.cuh`` (tests/test_torch_host_harness.py)."""

import numpy as np
import pytest

from smartbft_tpu.crypto import bls12381 as jbls
from smartbft_tpu_torch.crypto import bls12381 as tbls
from smartbft_tpu_torch.crypto import bls_stages as bs
from smartbft_tpu_torch.crypto import cuda_bls as cbl

P = tbls.P
R = 1 << 384


@pytest.fixture(scope="module")
def prog():
    return bs.program()


def _decode(prog):
    """Per stage: [(op, dst, slots read)]."""
    w = [int(x) for x in prog.words]
    jobs_at = w[bs.HEADER - 1]
    stages = []
    for s in range(prog.nstages):
        jobs = []
        for j in range(w[bs.HEADER + s], w[bs.HEADER + s + 1]):
            w0, w1, w2, w3 = w[jobs_at + 4 * j:jobs_at + 4 * j + 4]
            op, dst, a = w0 >> 29, (w0 >> 20) & 511, (w0 >> 10) & 1023
            if op in (bs.OP_MUL, bs.OP_SQR):
                reads = [(x >> k) & 1023 for x in (w1, w2, w3)
                         for k in (0, 10, 20)][:8]
            elif op == bs.JOB_SUM:
                assert a <= bs.SUM_TERMS
                reads = [((w1, w2, w3)[k // 3] >> (10 * (k % 3))) & 511
                         for k in range(a)]
            else:
                reads = []
            jobs.append((op, dst, reads))
        stages.append(jobs)
    return stages


def test_the_operation_count_is_the_bound_s(prog):
    """Products and squarings mod p: ``cuda_bls.lane_ops`` exactly, so the
    bound counts the work the kernel does."""
    ops = cbl.lane_ops()
    assert (prog.counts["mul"], prog.counts["sqr"]) == (ops["b381_mul"],
                                                        ops["b381_sqr"])
    assert prog.rounds(1)["product_rounds"] == sum(ops.values())


def test_no_job_reads_what_another_job_of_its_stage_writes(prog):
    """The contract that makes the serialised ranks faithful: within a
    stage every job writes its own slot, no job reads a slot written in the
    same stage, nothing writes the fixed slots, and a stage holds products
    or sums and loads, not both."""
    for s, jobs in enumerate(_decode(prog)):
        dsts = [d for _, d, _ in jobs]
        assert len(set(dsts)) == len(dsts), s
        assert min(dsts) >= bs.N_FIXED, s
        reads = {x for _, _, r in jobs for x in r}
        assert not reads & set(dsts), s
        kinds = {op in (bs.OP_MUL, bs.OP_SQR) for op, _, _ in jobs}
        assert len(kinds) == 1, s
        assert all(x < prog.nslots for x in reads | set(dsts))


def test_header_and_layout(prog):
    w = prog.words
    assert w.dtype == np.uint32
    assert list(w[:4]) == [prog.nstages, sum(len(j) for j in _decode(prog)),
                           prog.nslots, prog.miller_stages]
    assert list(w[4:16]) == prog.result
    assert list(w[16:28]) == prog.miller_result
    assert w[28] % 4 == 0  # jobs are read as 16-byte words
    assert len(w) == w[28] + 4 * w[1]
    assert prog.nslots < bs.MAX_SLOTS
    assert 0 < prog.miller_stages < prog.nstages
    # more ranks, fewer rounds on the critical path
    r = [prog.rounds(g)["product_rounds"] for g in (1, 3, 6, 12)]
    assert r == sorted(r, reverse=True)


def _lane(item):
    words = cbl.verify_words([item])
    return [int.from_bytes(w[0].view(np.uint32).tobytes(), "little")
            for w in words[:8]]


def _h12(vals):
    it = iter(v * pow(R, -1, P) % P for v in vals)
    return tuple(tuple((next(it), next(it)) for _ in range(3))
                 for _ in range(2))


@pytest.mark.parametrize("group", [1, 12])
def test_the_program_computes_the_host_pairing(prog, group):
    """A valid vote and a vote under the wrong key: after the Miller
    loop's stages its slots hold the host Miller product of e(sig, -g2)
    e(H(m), pk), and after the last stage ``host_final_exp`` of it (1 for
    the valid vote); every product operand stays below 4p (``run_lane``
    asserts it)."""
    table = [int.from_bytes(r.tobytes(), "little") for r in cbl.const_table()]
    (sk0, pk0), (_, pk1) = (tbls.keygen(b"stages-%d" % i) for i in range(2))
    msg = b"stages-digest"
    sig = tbls.sign(sk0, msg)
    for pub, valid in ((pk0, True), (pk1, False)):
        inputs = _lane((msg, sig, pub))
        want = jbls.fp12_mul(
            jbls.HOST, jbls.host_miller_loop(tbls.deserialize_g1(sig),
                                             jbls.NEG_G2),
            jbls.host_miller_loop(jbls.hash_to_g1(msg),
                                  tbls.deserialize_g2(pub)))
        slots = bs.run_lane(prog, inputs, table, prog.miller_stages, group)
        assert _h12([slots[k] for k in prog.miller_result]) == want
        slots = bs.run_lane(prog, inputs, table, group=group)
        got = _h12([slots[k] for k in prog.result])
        assert got == jbls.host_final_exp(want)
        assert (got == jbls.fp12_one(jbls.HOST)) == valid
