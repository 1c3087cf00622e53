"""The port's edge-partitioned protein tower (caster_dta_torch/parallel/
partition.py) against the JAX package's on tests/test_partition.py's graphs.

- ``partition_protein_graph`` gives JAX's arrays bit for bit, with default
  and explicit budgets, and the same budget errors.
- The partitioned lbamodel tower and ``PartitionedJointGNN`` run in 2 gloo
  ranks (tests/torch_ranks.py) with the JAX package's weights
  (interop/from_jax.py), dropout off, against JAX's ``run_partitioned`` and
  ``run_partitioned_joint`` on the 8-device CPU mesh of tests/conftest.py:
  forward within 2e-5, tower gradients within 5e-4, joint score within
  1e-5 and joint gradients within rtol 1e-3 / atol 1e-5 (the JAX tests'
  own tolerances). The gradients are the port's contract: each rank's loss
  scaled by 1/G, summed over the ranks.
- With dropout on, the same models equal the port's single-device run from
  the same generator (global-canonical masks), within the same tolerances.
- ``partitioned_train_step`` takes the single-device step: one SGD step's
  loss and parameters within the joint gradients' tolerance.
- The partitioned tower's state-dict names are the lbamodel tower's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_rank_jobs as jobs
from caster_dta_torch.data.graphs import pad_graph, stack_graphs
from caster_dta_torch.interop.from_jax import StateDictWriter, load_jax_params
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.models.protein import VectorProteinGNN_LBAModel
from caster_dta_torch.parallel import partition
from caster_dta_tpu.data.graphs import pad_graph as jax_pad_graph
from caster_dta_tpu.data.graphs import stack_graphs as jax_stack_graphs
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.models.protein import VectorProteinGNN_LBAModel as JaxLBA
from caster_dta_tpu.parallel import mesh as jax_mesh
from caster_dta_tpu.parallel import partition as jax_partition
from test_partition import CONFIGS, _joint_kwargs, _random_graph
from torch_ranks import RankPool

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
TOWER_GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
JOINT_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, tmp_path_factory.mktemp("partition_ranks"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def case():
    cfg = CONFIGS["fast"]
    n, g, kw = cfg["n"], cfg["g"], cfg["kw"]
    raw = _random_graph(np.random.default_rng(7), n)
    e = raw["edge_index"].shape[1]
    return n, g, kw, raw, e


def _plan(fn, raw, g, **budgets):
    return fn(raw["node_s"], raw["node_v"], raw["edge_index"], raw["edge_s"], raw["edge_v"],
              raw["node_type"], raw["edge_type"], n_shards=g, **budgets)


@pytest.mark.parametrize("name", ["fast", "full"])
def test_planner_matches_jax_bit_for_bit(name):
    cfg = CONFIGS[name]
    raw = _random_graph(np.random.default_rng(7), cfg["n"])
    small = _random_graph(np.random.default_rng(11), cfg["n"] - 8)
    g = cfg["g"]
    base = _plan(jax_partition.partition_protein_graph, raw, g)
    budgets = dict(nodes_per_shard=-(-(cfg["n"] - 8) // g) + 2,
                   interior_edges_per_shard=base.int_src.shape[1] + 64,
                   boundary_edges_per_shard=base.bnd_src_ext.shape[1] + 64,
                   halo_per_peer=base.halo_per_peer + 8)
    for graph, kw in ((raw, {}), (small, budgets)):
        want = _plan(jax_partition.partition_protein_graph, graph, g, **kw)
        got = _plan(partition.partition_protein_graph, graph, g, **kw)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_budget_violations_raise_as_in_jax(case):
    _, g, _, raw, _ = case
    for kw, match in ((dict(interior_edges_per_shard=1), "interior_edges_per_shard"),
                      (dict(boundary_edges_per_shard=1), "boundary_edges_per_shard"),
                      (dict(halo_per_peer=1), "halo_per_peer"),
                      (dict(nodes_per_shard=4), "nodes_per_shard")):
        for fn in (jax_partition.partition_protein_graph, partition.partition_protein_graph):
            with pytest.raises(ValueError, match=match):
                _plan(fn, raw, g, **kw)


def test_state_dict_names_are_the_lbamodel_towers(case):
    _, _, kw, _, _ = case
    single = VectorProteinGNN_LBAModel(**kw, generator=torch.Generator().manual_seed(0))
    part = partition.PartitionedLBAProteinGNN(**kw, generator=torch.Generator().manual_seed(0))
    assert list(part.state_dict()) == list(single.state_dict())
    for k, v in single.state_dict().items():
        assert torch.equal(part.state_dict()[k], v), k
    joint = make_joint_gnn(*_joint_kwargs({**kw, "num_convs": 1})[:2],
                           **_joint_kwargs(kw)[2])
    assert partition.from_joint(joint).state_dict().keys() == joint.state_dict().keys()


@pytest.fixture(scope="module")
def jax_tower(case):
    n, g, kw, raw, e = case
    single = jax_stack_graphs([jax_pad_graph(**raw, n_pad=n, e_pad=e)])
    sharded = _plan(jax_partition.partition_protein_graph, raw, g)
    ref = JaxLBA(**kw)
    variables = jax.jit(ref.init)(jax.random.PRNGKey(0), single)
    model = jax_partition.PartitionedLBAProteinGNN(**kw, axis_name="gp")
    mesh = jax_mesh.make_mesh(g, axis_name="gp")
    run = lambda v: jax_partition.run_partitioned(model, v, sharded, mesh)
    out = np.asarray(run(variables))
    grads = jax.jit(jax.grad(lambda v: jnp.sum(run(v) ** 2)))(variables)
    return variables, out, grads


def _tower_state(kw, variables) -> dict:
    tower = VectorProteinGNN_LBAModel(**kw)
    w = StateDictWriter()
    w.lba_tower("m", variables["params"], tower)
    return w.tensors(strip="m.")


def _jax_leaf(tree, torch_name: str, kw) -> np.ndarray:
    """The JAX gradient of a port tower parameter, in the port's layout."""
    tower = VectorProteinGNN_LBAModel(**kw)
    w = StateDictWriter()
    w.lba_tower("m", tree["params"], tower)
    return w.sd["m." + torch_name]


def test_tower_forward_and_gradients_match_jax(pool, case, jax_tower):
    n, g, kw, raw, _ = case
    variables, want, grads = jax_tower
    sharded = _plan(partition.partition_protein_graph, raw, g)
    res = pool.run(jobs.tower_job, kw, _tower_state(kw, variables), sharded)
    for r in res:
        np.testing.assert_allclose(r["out"].numpy(), want, **FWD_TOL)
    assert all(torch.equal(res[0]["grads"][k], res[1]["grads"][k]) for k in res[0]["grads"])
    for name, got in res[0]["grads"].items():
        np.testing.assert_allclose(got.numpy(), _jax_leaf(grads, name, kw), err_msg=name,
                                   **TOWER_GRAD_TOL)


def _molecule(seed: int = 3):
    """tests/test_partition.py's _mol_batch graph, padded by both packages."""
    rng = np.random.default_rng(seed)
    n, e = 7, 18
    raw = dict(node_s=rng.normal(size=(n, 41)).astype(np.float32), node_v=None,
               edge_index=rng.integers(0, n, size=(2, e)),
               edge_s=rng.normal(size=(e, 9)).astype(np.float32), edge_v=None,
               node_type=rng.integers(0, 11, n), edge_type=rng.integers(0, 5, e))
    return (jax_stack_graphs([jax_pad_graph(**raw, n_pad=8, e_pad=24)]),
            stack_graphs([pad_graph(**raw, n_pad=8, e_pad=24)]))


def test_joint_forward_and_gradients_match_jax(pool, case):
    n, g, kw, raw, e = case
    pk, mk, jk = _joint_kwargs({**kw, "num_convs": 1})
    jax_mol, mol = _molecule()
    target = np.asarray([1.3], np.float32)
    single = jax_stack_graphs([jax_pad_graph(**raw, n_pad=n, e_pad=e)])
    variables = jax.jit(jax_make_joint_gnn(pk, mk, **jk).init)(jax.random.PRNGKey(0), single,
                                                                jax_mol)
    jsh = _plan(jax_partition.partition_protein_graph, raw, g)
    jmodel = jax_partition.PartitionedJointGNN(protein_gnn_kwargs=pk, molecule_gnn_kwargs=mk,
                                               **jk, partition_axis="gp")
    mesh = jax_mesh.make_mesh(g, axis_name="gp")
    score_want = np.asarray(jax_partition.run_partitioned_joint(jmodel, variables, jsh,
                                                                jax_mol, mesh))
    sh_spec, mol_spec = jax_partition.partitioned_joint_in_specs("gp")

    def part_loss(p):
        def fwd(p, sh, m, t):
            score, _ = jmodel.apply({"params": p}, sh, m, deterministic=True)
            return jax.lax.pmean((score[0, 0] - t[0]) ** 2, ("gp",))
        return jax.shard_map(fwd, mesh=mesh, in_specs=(P(), sh_spec, mol_spec, P()),
                             out_specs=P(), check_vma=False)(
            p, jax_partition.stack_sharded([jsh]), jax_mol, jnp.asarray(target))

    jgrads = jax.jit(jax.grad(part_loss))(variables["params"])

    port = make_joint_gnn(pk, mk, **jk)
    load_jax_params(port, variables)
    state = port.state_dict()
    sharded = _plan(partition.partition_protein_graph, raw, g)
    res = pool.run(jobs.joint_job, (pk, mk, jk), state, sharded, mol, torch.tensor(target))
    for r in res:
        np.testing.assert_allclose(r["score"].numpy(), score_want, **SCORE_TOL)
    want = {}
    w = StateDictWriter()
    w.joint(jgrads, port)
    want = w.sd
    for name, got in res[0]["grads"].items():
        np.testing.assert_allclose(got.numpy(), want[name], err_msg=name, **JOINT_GRAD_TOL)


def test_dropout_runs_equal_the_single_device_port(pool, case):
    """Training mode, dropout 0.2 in the tower and the joint model: the
    partitioned runs draw the global-canonical masks, so they equal the
    single-device port model on the same generator."""
    n, g, kw, raw, e = case
    gen_seed = 5
    single_graph = stack_graphs([pad_graph(**raw, n_pad=n, e_pad=e)])
    tower = VectorProteinGNN_LBAModel(**kw, generator=torch.Generator().manual_seed(1)).train()
    out = tower(single_graph, generator=torch.Generator().manual_seed(gen_seed))[0]
    (out ** 2).sum().backward()
    sharded = _plan(partition.partition_protein_graph, raw, g)
    res = pool.run(jobs.tower_job, kw, tower.state_dict(), sharded, True, gen_seed)
    np.testing.assert_allclose(res[0]["out"].numpy(), out.detach().numpy(), **FWD_TOL)
    for name, p in tower.named_parameters():
        np.testing.assert_allclose(res[0]["grads"][name].numpy(), p.grad.numpy(),
                                   err_msg=name, **TOWER_GRAD_TOL)

    pk, mk, jk = _joint_kwargs({**kw, "num_convs": 1})
    jk = dict(jk, dropout=0.1)
    mk = dict(mk, dropout_rate=0.2)
    _, mol = _molecule()
    target = torch.tensor([1.3])
    joint = make_joint_gnn(pk, mk, generator=torch.Generator().manual_seed(2), **jk).train()
    score, _ = joint(single_graph, mol, generator=torch.Generator().manual_seed(gen_seed))
    loss = torch.sum((score[:, 0] - target) ** 2)
    loss.backward()
    res = pool.run(jobs.joint_job, (pk, mk, jk), joint.state_dict(), sharded, mol, target, True,
                   gen_seed)
    np.testing.assert_allclose(res[1]["score"].numpy(), score.detach().numpy(), **SCORE_TOL)
    for name, p in joint.named_parameters():
        np.testing.assert_allclose(res[1]["grads"][name].numpy(), p.grad.numpy(),
                                   err_msg=name, **JOINT_GRAD_TOL)


def test_partitioned_train_step_takes_the_single_device_step(pool, case):
    n, g, kw, raw, e = case
    pk, mk, jk = _joint_kwargs({**kw, "num_convs": 1})
    _, mol = _molecule()
    target = torch.tensor([1.3])
    joint = make_joint_gnn(pk, mk, generator=torch.Generator().manual_seed(4), **jk)
    state = {k: v.clone() for k, v in joint.state_dict().items()}
    joint.eval()
    score, _ = joint(stack_graphs([pad_graph(**raw, n_pad=n, e_pad=e)]), mol)
    loss = torch.mean((score[:, 0] - target) ** 2)
    loss.backward()
    loss = loss.detach()
    with torch.no_grad():
        for p in joint.parameters():
            p -= 0.1 * p.grad
    sharded = _plan(partition.partition_protein_graph, raw, g)
    res = pool.run(jobs.train_step_job, (pk, mk, jk), state, sharded, mol, target)
    for r in res:
        np.testing.assert_allclose(r["loss"], loss.item(), **SCORE_TOL)
        for name, want in joint.state_dict().items():
            np.testing.assert_allclose(r["params"][name].numpy(), want.numpy(), err_msg=name,
                                       **JOINT_GRAD_TOL)
