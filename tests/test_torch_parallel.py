"""The port's process meshes and multi-process initialization
(dgdm_tpu_torch/parallel/mesh.py, distributed.py) against the JAX
package's (dgdm_tpu/parallel/) on the same inputs, with the conftest's 8
CPU devices: the (dp, sp) factorisation for 1-8 devices, each rank's block
of a global batch against the shard JAX places on the device of that
position, ``pad_to_multiple``, ``process_local_batch_slice``, and the
environment contract of ``maybe_initialize_distributed`` (with
``init_process_group`` faked)."""

import numpy as np
import jax
import pytest
import torch

from dgdm_tpu.parallel import distributed as jdist
from dgdm_tpu.parallel import mesh as jmesh
from dgdm_tpu_torch.parallel import distributed as tdist
from dgdm_tpu_torch.parallel import mesh as tmesh

ENV = ("DGDM_COORDINATOR", "DGDM_NUM_NODES", "NUM_NODES", "NODE_RANK",
       "PROCESS_ID")


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    for axes in (("dp", "sp"), ("dp",)):
        ref = dict(jmesh.make_mesh(n, axes=axes).shape)
        assert tmesh.mesh_shape(n, axes) == ref, (n, axes)


def _rank_mesh(r, shape):
    sp = shape.get("sp", 1)
    coords = {"dp": r // sp} if "sp" not in shape else \
        {"dp": r // sp, "sp": r % sp}
    return tmesh.Mesh(r, int(np.prod(list(shape.values()))), shape, coords,
                      {}, {})


@pytest.mark.parametrize("rows", [16, 19])
def test_shard_global_batch_blocks_match_jax(rows):
    """Rank r keeps the rows JAX puts on device r of a dp mesh; rows are
    trimmed to a multiple of the axis first."""
    rs = np.random.RandomState(rows)
    batch = {"a": rs.randn(rows, 3).astype(np.float32),
             "b": rs.randn(rows).astype(np.float32)}
    mesh = jmesh.data_parallel_mesh()
    ref = jmesh.shard_global_batch(mesh, batch, "dp")
    n = mesh.shape["dp"]
    for r in range(n):
        m = _rank_mesh(r, {"dp": n})
        got = tmesh.shard_global_batch(m, batch)
        for k in batch:
            shard = [s for s in ref[k].addressable_shards
                     if s.device == mesh.devices[r]][0]
            np.testing.assert_array_equal(got[k], np.asarray(shard.data))
        # torch tensors and trees with a dataclass shard alike
        t = tmesh.shard_batch(m, torch.from_numpy(batch["a"]))
        np.testing.assert_array_equal(t.numpy(), got["a"])
    with pytest.raises(ValueError):
        tmesh.shard_batch(_rank_mesh(0, {"dp": 2}),
                          {"a": np.zeros(4), "b": np.zeros(5)})


def test_mesh_coordinates_match_jax_device_grid():
    """Rank i * sp + j sits where JAX's (dp, sp) mesh puts device i * sp + j;
    its dp block of a batch sharded over ('dp', 'sp') rows."""
    mesh = jmesh.make_mesh(8, axes=("dp", "sp"))
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for i in range(dp):
        for j in range(sp):
            r = int(ids[i, j])
            m = _rank_mesh(r, {"dp": dp, "sp": sp})
            assert (m.index("dp"), m.index("sp")) == (i, j)
            assert tmesh.block(m, 8, "sp") == slice(4 * j, 4 * j + 4)


@pytest.mark.parametrize("n,k", [(5, 4), (8, 4), (1, 3)])
def test_pad_to_multiple_matches_jax(n, k):
    batch = {"x": np.arange(n * 2, dtype=np.float32).reshape(n, 2),
             "y": np.arange(n)}
    got, gn = tmesh.pad_to_multiple(batch, k)
    ref, rn = jmesh.pad_to_multiple(batch, k)
    assert gn == rn == n
    for key in batch:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]))


def test_process_local_batch_slice_matches_jax(monkeypatch):
    for world in (1, 2, 4):
        for r in range(world):
            monkeypatch.setattr(jax, "process_count", lambda: world)
            monkeypatch.setattr(jax, "process_index", lambda: r)
            monkeypatch.setattr(tdist, "world_size", lambda: world)
            monkeypatch.setattr(tdist, "rank", lambda: r)
            for n in (8, 10):
                assert tdist.process_local_batch_slice(n) == \
                    jdist.process_local_batch_slice(n)


def test_distributed_init_noop_single_host(monkeypatch):
    """maybe_initialize_distributed is a no-op without the environment
    contract and turns the contract into init_process_group's arguments."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tdist, "_INITIALIZED", False)
    assert tdist.maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()

    calls = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DGDM_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("DGDM_NUM_NODES", "2")
    monkeypatch.setenv("NODE_RANK", "1")
    assert tdist.maybe_initialize_distributed(verbose=False) is True
    assert calls == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                     "rank": 1, "world_size": 2}
    # the JAX names of the same contract
    calls.clear()
    monkeypatch.setattr(tdist, "_INITIALIZED", False)
    for var in ("DGDM_NUM_NODES", "NODE_RANK"):
        monkeypatch.delenv(var)
    monkeypatch.setenv("NUM_NODES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    assert tdist.maybe_initialize_distributed(verbose=False,
                                              backend="gloo") is True
    assert calls["rank"] == 3 and calls["world_size"] == 4
    # a contract without a rank is refused
    monkeypatch.setattr(tdist, "_INITIALIZED", False)
    monkeypatch.delenv("PROCESS_ID")
    with pytest.raises(ValueError):
        tdist.maybe_initialize_distributed(verbose=False)
    monkeypatch.setattr(tdist, "_INITIALIZED", False)


def test_one_process_helpers_are_identities():
    """Without a process group: no mesh for data parallelism, the one-rank
    mesh, and collectives that leave their inputs as they are."""
    assert tmesh.data_parallel_mesh() is None
    m = tmesh.make_mesh()
    assert m.shape == {"dp": 1, "sp": 1} and m.coords == {"dp": 0, "sp": 0}
    x = torch.arange(6.0).reshape(3, 2)
    assert tmesh.all_gather_rows(m, x) is x
    assert tmesh.all_reduce_sum(m, x, "sp") is x
    v = x[0, 0]
    assert tmesh.mean_over_dp(None, {"a": v})["a"] is v
    with pytest.raises(ValueError):
        tmesh.make_mesh(2)
