"""The port's ``parallel/`` against the JAX package's, in one process.

- ``MeshConfig.resolve``, case for case, errors included;
- ``param_pspecs`` of the tiny speech model of
  tests/test_torch_parallel_train.py (and of a wav2vec2 tree) on a (data 1,
  fsdp 2|4) mesh, equal to JAX's on the same tree and mesh shape, compared
  as tuples; ``_shrink_spec`` dropping and warning on the same leaves;
  ``rules_for_mesh``'s pipe table;
- ``sharded_iterator``, ``sharded_batch_iterator`` and ``ShardedDataset``
  equal to JAX's;
- the helpers' single-process behaviour: every collective a no-op, the
  mesh of ones without groups (with or without a process group of one),
  ``shard_params`` the identity;
- ``make_mesh`` laying out a pipe axis (each rank's stage and its
  neighbours) and a tensor axis.

The multi-process semantics are in tests/test_torch_parallel_train.py.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_parallel_train import configs, jax_params
from tests.torch_parity import make_w2v_configs, make_w2v_params
from ultravox_torch.parallel import collectives as tcol
from ultravox_torch.parallel import mesh as tmesh
from ultravox_torch.parallel import multihost as tmh
from ultravox_torch.parallel import sharding as tsh
from ultravox_torch.training import train_step as tts
from ultravox_tpu.parallel import collectives as jcol
from ultravox_tpu.parallel import mesh as jmesh
from ultravox_tpu.parallel import multihost as jmh
from ultravox_tpu.parallel import sharding as jsh


@pytest.mark.parametrize("dims,n", [
    ((1, -1, 1, 1), 8), ((2, -1, 1, 1), 8), ((1, 2, 1, 1), 8), ((2, 2, 2, 1), 8),
    ((1, -1, 2, 1), 4), ((1, 1, 1, 1), 1), ((-1, 1, 1, 1), 6),
    ((-1, -1, 1, 1), 8), ((3, -1, 1, 1), 8), ((4, 4, 1, 1), 8), ((1, 3, 1, 1), 2),
])
def test_mesh_config_resolve_matches_jax(dims, n):
    def run(mod):
        try:
            return mod.MeshConfig(*dims).resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tmesh) == run(jmesh)


def _jax_mesh(fsdp, data=1, pipe=1):
    return jmesh.make_mesh(jmesh.MeshConfig(data=data, fsdp=fsdp, tensor=1, pipe=pipe),
                           jax.devices()[: data * fsdp * pipe])


def _as_tuples(specs):
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _trees(name):
    if name == "whisper":
        jcfg, tcfg = configs()
        jp = jax_params(jcfg)
    else:
        jcfg, tcfg = make_w2v_configs("layer")
        jp, _ = make_w2v_params(jcfg, tcfg)
    from ultravox_torch.models.weights import from_jax_params

    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg)


@pytest.mark.parametrize("tower", ["whisper", "wav2vec2"])
@pytest.mark.parametrize("fsdp", [2, 4])
def test_param_pspecs_match_jax(tower, fsdp):
    jp, tp = _trees(tower)
    want = dict(tts._path_items(_as_tuples(jsh.param_pspecs(jp, jsh.DEFAULT_RULES,
                                                            _jax_mesh(fsdp)))))
    mesh = tmesh.Mesh.local(tmesh.MeshConfig(1, fsdp), fsdp)
    got = dict(tts._path_items(tsh.param_pspecs(tp, tsh.DEFAULT_RULES, mesh)))
    assert got == want
    assert sum("fsdp" in s for s in got.values()) >= 8
    # the rules as the JAX package writes them, without a mesh
    assert dict(tts._path_items(tsh.param_pspecs(tp))) == dict(tts._path_items(
        _as_tuples(jsh.param_pspecs(jp))))


def test_default_rules_are_the_jax_table():
    assert [(p, s) for p, s in tsh.DEFAULT_RULES] == [
        (p, tuple(s)) for p, s in jsh.DEFAULT_RULES]


def test_rules_for_mesh_pipe_table_matches_jax():
    want = [(p, tuple(s)) for p, s in jsh.rules_for_mesh(_jax_mesh(2, pipe=2))]
    got = tsh.rules_for_mesh(tmesh.Mesh.local(tmesh.MeshConfig(1, 2, 1, 2), 4))
    assert got == want and any(s[:1] == ("pipe",) for _, s in got)
    assert tsh.rules_for_mesh(tmesh.Mesh.local(tmesh.MeshConfig(1, 2), 2)) is tsh.DEFAULT_RULES


ODD = {  # (path, shape): dims that a mesh axis of 2 or 4 may not divide
    "language_model": {"embed_tokens": (1027, 1025), "lm_head": {"kernel": (1027, 1026)},
                       "layers": {"q_proj": {"kernel": (2, 1030, 64)},
                                  "down_proj": {"kernel": (2, 96, 2050)}}},
    "audio_tower": {"embed_positions": (1500, 66), "layers": {"fc1": {"kernel": (2, 10, 8)}}},
    "projector": {"linear_1": {"kernel": (1028, 8)}},
}


def _shape_tree(tree, make):
    return {k: _shape_tree(v, make) if isinstance(v, dict) else make(v) for k, v in tree.items()}


@pytest.mark.parametrize("fsdp", [2, 4])
def test_shrink_spec_drops_and_warns_like_jax(fsdp, caplog):
    with caplog.at_level(logging.WARNING):
        want = jsh.param_pspecs(_shape_tree(ODD, lambda s: jax.ShapeDtypeStruct(s, np.float32)),
                                jsh.DEFAULT_RULES, _jax_mesh(fsdp))
    jwarn = sorted(r.getMessage() for r in caplog.records if "sharding rule dropped" in
                   r.getMessage())
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        got = tsh.param_pspecs(_shape_tree(ODD, lambda s: torch.empty(s, device="meta")),
                               tsh.DEFAULT_RULES, tmesh.Mesh.local(tmesh.MeshConfig(1, fsdp), fsdp))
    twarn = sorted(r.getMessage() for r in caplog.records if "sharding rule dropped" in
                   r.getMessage())
    assert dict(tts._path_items(got)) == dict(tts._path_items(_as_tuples(want)))
    # the same leaves and dims; the port's message says memory for HBM
    assert [w.replace("HBM", "memory") for w in jwarn] == twarn and twarn


@pytest.mark.parametrize("n,shards,batch", [(10, 3, 2), (7, 2, 4), (5, 4, 1), (3, 4, 2)])
def test_sharded_iterators_match_jax(n, shards, batch):
    items = [f"s{i}" for i in range(n)]
    for rank in range(shards):
        assert (list(tcol.sharded_iterator(items, shards, rank))
                == list(jcol.sharded_iterator(items, shards, rank)))
        assert (list(tcol.sharded_batch_iterator(items, batch, shards, rank))
                == list(jcol.sharded_batch_iterator(items, batch, shards, rank)))
        t, j = tmh.ShardedDataset(items, shards, rank), jmh.ShardedDataset(items, shards, rank)
        assert list(t) == list(j) and list(t) == list(t)  # restartable
        assert len(t) == len(j) == len(list(t))


def test_collectives_are_noops_in_one_process():
    assert (tcol.process_index(), tcol.process_count(), tcol.is_global_master()) == (0, 1, True)
    assert tcol.all_gather_list([3, "a"]) == [3, "a"]
    tcol.sync_hosts()
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1, "pipe": 1}
    assert set(mesh.groups.values()) == {None} and mesh.batch_shards == 1
    tree = {"a": {"kernel": torch.ones(4, 2)}, "b": [torch.zeros(3)]}
    assert tsh.shard_params(tree, mesh) is tree
    assert tsh.gather(tree["a"]["kernel"]) is tree["a"]["kernel"]
    assert tsh.gather_tree(tree)["b"][0] is tree["b"][0]
    g = [torch.ones(2)]
    assert tsh.reduce_gradients(tree["b"], g, mesh)[0] is g[0]


def test_make_mesh_refuses_tensor_and_pipe(monkeypatch):
    """Neither axis is refused any more: pipe 2 and tensor 2 lay out (no
    process group here, so no groups). Pipe is the last axis, so a rank's
    stage neighbours are the ranks beside it, and pipe peers read the same
    rows."""
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(1, 1, 1, 2))
    assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1, "pipe": 2}
    assert mesh.coords == {"data": 0, "fsdp": 0, "tensor": 0, "pipe": 1}
    assert (mesh.rank, mesh.stage, mesh.n_stages) == (1, 1, 2)
    assert (mesh.prev_stage_rank, mesh.next_stage_rank) == (0, None)
    assert mesh.batch_shards == 1 and mesh.batch_index == 0
    monkeypatch.setattr(tmesh, "process_count", lambda: 8)
    monkeypatch.setattr(tmesh, "process_index", lambda: 5)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(1, 2, 1, 4))  # fsdp 2 x pipe 4
    assert mesh.coords == {"data": 0, "fsdp": 1, "tensor": 0, "pipe": 1}
    assert (mesh.stage, mesh.prev_stage_rank, mesh.next_stage_rank) == (1, 4, 6)
    assert mesh.batch_shards == 2 and mesh.batch_index == 1
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(1, 1, 2, 1))
    assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 2, "pipe": 1}
    assert mesh.coords["tensor"] == 1 and mesh.batch_shards == 1 and mesh.batch_index == 0
    with pytest.raises(ValueError, match="must cover all 2 processes"):
        tmesh.make_mesh(tmesh.MeshConfig(1, 1, 1, 1))


def test_mesh_of_one_process_has_no_groups(tmp_path):
    """A process group of one (``torchrun --nproc_per_node 1``) lays a mesh
    with no groups: nothing needs to travel, so no step issues a
    collective."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        mesh = tmesh.make_mesh()
        assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1, "pipe": 1}
        assert set(mesh.groups.values()) == {None}
    finally:
        dist.destroy_process_group()
