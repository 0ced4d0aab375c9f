"""The reference's failover, fault, reconfig and backpressure case
matrices against the port: ``tests/test_failover.py``, ``test_faults.py``,
``test_reconfig.py`` and ``test_backpressure.py``, compiled against
``smartbft_tpu_torch`` by :mod:`torch_reference` and collected here as
items of their own (``<file stem>__<case>``), under an exact count guard.
Among them the coalescer's view-flip warm path
(``test_failover__test_coalescer_flip_warm_*``)."""

from torch_reference import check_matrices, reference_tests

CASES = {"test_failover.py": 19, "test_faults.py": 10,
         "test_reconfig.py": 18, "test_backpressure.py": 4}
LEFT_OUT: dict = {}

for _file in CASES:
    globals().update(reference_tests(_file))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT)


def test_a_view_change_warms_the_shared_coalescer(tmp_path):
    """The port's App forwards the provider's view-flip seams, so a view
    change in a cluster of Apps reaches the shared coalescer: muting a
    shard's leader until the others install a new view runs the flip
    warm (``flip_warms``) before the cluster stops, and the shard then
    commits in the new view."""
    import asyncio

    from smartbft_tpu_torch.testing.app import wait_for
    from smartbft_tpu_torch.testing.sharded import ShardedCluster

    async def run(tmp):
        cluster = ShardedCluster(tmp, shards=1, n=4, depth=2, seed=11)
        scheduler, shard = cluster.scheduler, cluster.shard(0)
        await cluster.start()
        try:
            await cluster.submit(cluster.client_for_shard(0), "before")
            await wait_for(lambda: cluster.committed_requests(0) >= 1,
                           scheduler, timeout=90.0)
            assert cluster.coalescer.flip_warms == 0
            old = shard.mute_leader()
            others = [a for a in shard.apps if a.id != old]
            await wait_for(
                lambda: {a.consensus.get_leader_id() for a in others}
                - {0, old} and len({a.consensus.get_leader_id()
                                    for a in others}) == 1,
                scheduler, timeout=240.0)
            warms = cluster.coalescer.flip_warms
            shard.unmute(old)
            await cluster.submit(cluster.client_for_shard(0, 1), "after")
            await wait_for(lambda: cluster.committed_requests(0) >= 2,
                           scheduler, timeout=240.0)
            cluster.check_invariants()
            return warms
        finally:
            await cluster.stop()

    assert asyncio.run(run(tmp_path)) >= 1
