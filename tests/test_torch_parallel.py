"""The port's data parallelism (parallel/distributed.py) on the CPU: two
ranks of a gloo process group, each a spawned process
(tests/torch_parallel_ranks.py), hold one global batch split in two, and
must reproduce one process at that global batch. The twins of the JAX
package's tests/test_sharding.py and of
tests/test_block_engine.py::test_engine_grad_parity_under_shardmap, in f32
(TF32 off), JAX on one device with Pallas in interpret mode.

Each rank differentiates its own objective; the ranks' objectives sum to
the global one, so a rank's input gradient equals the global input
gradient's rows, and the ranks' parameter gradients sum to the global
parameter gradient. The train step averages them (the global batch's mean
loss). A BN gradient summed inside the engine as well would come out
world-size times too large here.

Tolerances: the engine at the JAX engine test's own (values rtol 1e-5, input gradient
rtol 1e-3 / atol 2e-4, parameter gradients rtol 1e-3 / atol 1e-3); the
train steps at tests/test_torch_training.py's (losses and the grad norm
rtol 1e-3 against JAX and 1e-4 between the port's runs, new parameters
within 1e-5 of their largest element, new BN statistics rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu.data import augment as jaugment
from endoscopydepthestimation_pytorch_tpu.data import dataset as jdataset
from endoscopydepthestimation_pytorch_tpu.models.fcdensenet import FCDenseNet as JaxFCDenseNet
from endoscopydepthestimation_pytorch_tpu.ops import block_engine as jax_engine
from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.data import augment, dataset, readers
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet
from endoscopydepthestimation_pytorch_tpu_torch.parallel import distributed

import torch_parallel_ranks as ranks
from test_torch_block_engine import _block_inputs
from test_torch_training import (CONFIG, DCL, TINY, TINY_ARCH, _assert_tensors_close,
                                 _conditioned, _jax_step, _named_jax, _port_model,
                                 _to_torch, pallas_interpret)  # noqa: F401 (autouse)
from test_training import _synthetic_batch
from torch_port_cases import seeded_jax_state
from torch_sfm_sequence import write_sequence

WORLD = 2
ENGINE_CASE = (8, 8, 16, 6, 4, 3)  # (b, h, w, c0, growth, n_layers), global b


def _engine_inputs():
    b, h, w, c0, growth, n_layers = ENGINE_CASE
    x, params, _ = _block_inputs(b, h, w, c0, growth, n_layers, seed=0)
    rng = np.random.RandomState(1)
    ctot = c0 + n_layers * growth
    weights = (rng.randn(b, h, w, ctot).astype(np.float32),
               rng.randn(ctot).astype(np.float32), rng.randn(ctot).astype(np.float32))
    return x, params, weights


@pytest.fixture(scope="module")
def inputs():
    """The global inputs of every check, and the JAX states they start from."""
    x, params, weights = _engine_inputs()
    engine = (torch.from_numpy(x),
              [[torch.from_numpy(p) for p in group] for group in params],
              [torch.from_numpy(t) for t in weights])
    # the TINY engine net of test_seed4_tiny_engine_step_matches_jax
    jstep = _conditioned(seeded_jax_state(
        JaxFCDenseNet(block_engine=True, block_engine_levels=("denseBlocksDown1",),
                      **TINY_ARCH), (8, 32, 32, 3), seed=4))
    step_batch = _synthetic_batch(seed=4, batch=4, h=32, w=32)
    # the TINY net and batch of test_grad_accum_2_matches_jax
    jaccum = _conditioned(seeded_jax_state(JaxFCDenseNet(**TINY_ARCH),
                                           (4, 32, 40, 3), seed=6))
    accum_batch = _synthetic_batch(seed=7, batch=4, h=32, w=40)
    sd = {name: _port_model(j, FCDenseNet(**TINY_ARCH), **TINY).state_dict()
          for name, j in (("step", jstep), ("grad_accum", jaccum))}
    return {
        "engine": engine,
        "step": (TINY_ARCH, sd["step"], _to_torch(step_batch)),
        "grad_accum": (TINY_ARCH, sd["grad_accum"], _to_torch(accum_batch)),
        "jax": {"step": (jstep, step_batch), "params": params, "x": x, "weights": weights},
    }


@pytest.fixture(scope="module")
def session(inputs, tmp_path_factory):
    """Both ranks' results of ``torch_parallel_ranks.session``."""
    rank_inputs = {k: v for k, v in inputs.items() if k != "jax"}
    codes, errs, results = ranks.run_ranks(
        ranks.session, WORLD, tmp_path_factory.mktemp("session"), rank_inputs)
    assert codes == [0] * WORLD, "\n".join(errs)
    return results


def _rows_cat(results, part, key):
    return torch.cat([r[part][key] for r in results]).numpy()


def test_engine_at_two_ranks_matches_jax(inputs, session):
    """(2) ``block_engine_apply`` at 4 rows a rank against JAX's engine on
    one device at the global b8 (Pallas in interpret mode): the buffer's
    rows, the global statistics, the input gradient's rows, and the
    ranks' parameter gradients summed."""
    b, h, w, c0, growth, n_layers = ENGINE_CASE
    j = inputs["jax"]
    w_buf, w_mu, w_m2 = (jnp.asarray(t) for t in j["weights"])

    def loss(x, params):
        buf, mu, m2 = jax_engine.block_engine_apply((growth, n_layers, 1e-5, None),
                                                    x, *params)
        return (jnp.sum(buf * w_buf) + jnp.sum(buf * (mu * w_mu + m2 * w_m2)),
                (buf, mu, m2))

    jparams = tuple(tuple(jnp.asarray(p) for p in group) for group in j["params"])
    (_, (buf, mu, m2)), (gx, gparams) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(j["x"]), jparams)

    np.testing.assert_allclose(_rows_cat(session, "engine", "buf"), np.asarray(buf),
                               rtol=1e-5, atol=1e-5)
    for r in session:
        np.testing.assert_allclose(r["engine"]["mu"].numpy(), np.asarray(mu),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["engine"]["m2"].numpy(), np.asarray(m2),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_rows_cat(session, "engine", "gx"), np.asarray(gx),
                               rtol=1e-3, atol=2e-4)
    want = jax.tree.leaves(gparams)
    got = [sum(r["engine"]["gparams"][i] for r in session) for i in range(len(want))]
    for i, (g, wnt) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-3, atol=1e-3,
                                   err_msg=str(i))


def _assert_same_step(got: dict, want_metrics: dict, want_state: dict, rtol: float):
    for key in ("loss", "sparse_flow_loss", "depth_consistency_loss", "grad_norm"):
        np.testing.assert_allclose(float(got["metrics"][key]), float(want_metrics[key]),
                                   rtol=rtol, err_msg=key)
    _assert_tensors_close(got["model"], {k: v for k, v in want_state.items()
                                         if "running" not in k}, 1e-5, "param")
    for k in (k for k in want_state if "running" in k):
        np.testing.assert_allclose(got["model"][k].numpy(), want_state[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def _assert_replicated(a: dict, b: dict):
    """Both ranks hold the same model, momentum, count and step, bit for bit."""
    assert all(torch.equal(a["model"][k], v) for k, v in b["model"].items())
    assert all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"]))
    assert (a["count"], a["step"]) == (b["count"], b["step"])


def test_train_step_at_two_ranks_matches_jax(inputs, session):
    """(3) The TINY engine net at 2 rows a rank (B = 4, 32x32) against the
    JAX step at the global B = 4 (its 16x16 down block through the Pallas
    engine), and against the port's own step at world size 1."""
    jstate, batch = inputs["jax"]["step"]
    _, _, _, _, jnew, jmetrics = _jax_step(jstate, batch, False)
    _assert_same_step(session[0]["step"], jmetrics,
                      _named_jax(jnew.params, jnew.batch_stats, **TINY), 1e-3)

    arch, state_dict, tbatch = inputs["step"]
    model = FCDenseNet(**arch)
    model.load_state_dict(state_dict)
    state, metrics = training.train_step(training.create_train_state(model), tbatch,
                                         torch.tensor(DCL), CONFIG)
    _assert_same_step(session[0]["step"], metrics, state.model.state_dict(), 1e-4)
    _assert_replicated(*(r["step"] for r in session))
    assert session[0]["step"]["step"] == session[0]["step"]["count"] == 1


def test_remat_and_act8_at_two_ranks(session):
    """The engine step of (3) with ``remat`` and with ``act8`` at 2 rows a
    rank, whose backward replays each block's forward and its statistics'
    all-reduces: ``remat`` equals the engine step bit for bit; ``act8``'s
    loss and new BN statistics equal it bit for bit (its forward is exact)
    and its update, the first step's momentum (the clipped gradient), keeps
    a cosine above 0.99 with the engine step's. Both ranks stay
    bitwise equal."""
    for r in session:
        engine, remat, act8 = r["step"], r["remat"], r["act8"]
        assert all(torch.equal(remat["metrics"][k], v) for k, v in engine["metrics"].items())
        _assert_replicated(remat, engine)
        assert torch.equal(act8["metrics"]["loss"], engine["metrics"]["loss"])
        assert all(torch.equal(act8["model"][k], v) for k, v in engine["model"].items()
                   if "running" in k)
        got = torch.cat([b.flatten() for b in act8["momentum"]]).double()
        want = torch.cat([b.flatten() for b in engine["momentum"]]).double()
        assert float(got @ want / got.norm() / want.norm()) > 0.99
    _assert_replicated(*(r["act8"] for r in session))


def test_eval_step_at_two_ranks_matches_one_process(inputs, session):
    """``eval_step`` with the batch statistics at 2 rows a rank: BN over the
    global batch and the losses averaged, as one process at B = 4 (JAX
    ``make_parallel_eval_step``); the running statistics untouched."""
    arch, state_dict, tbatch = inputs["step"]
    model = FCDenseNet(**arch)
    model.load_state_dict(state_dict)
    want = training.eval_step(training.create_train_state(model), tbatch,
                              torch.tensor(DCL), CONFIG, use_batch_stats=True)
    for r in session:
        assert sorted(r["eval"]) == sorted(want)
        for key, value in want.items():
            np.testing.assert_allclose(float(r["eval"][key]), float(value), rtol=1e-4,
                                       err_msg=key)
    assert all(torch.equal(v, state_dict[k]) for k, v in model.state_dict().items())


def test_grad_accum_at_two_ranks_matches_one_process(inputs, session):
    """(4) ``grad_accum=2`` at 2 rows a rank: each rank's rows m::2, whose
    union is the global batch's microbatch m, against one process's
    ``grad_accum=2`` at the global B = 4."""
    arch, state_dict, tbatch = inputs["grad_accum"]
    model = FCDenseNet(**arch)
    model.load_state_dict(state_dict)
    state, metrics = training.train_step(training.create_train_state(model), tbatch,
                                         torch.tensor(DCL), CONFIG, grad_accum=2)
    _assert_same_step(session[0]["grad_accum"], metrics, state.model.state_dict(), 1e-4)
    _assert_replicated(*(r["grad_accum"] for r in session))


def test_non_finite_guard_agrees_across_ranks(session):
    """(5) Rank 1's batch alone gives a NaN loss: the averaged loss is NaN
    on both ranks, so neither updates its parameters, momentum or count,
    and ``step`` stays put on both; the BN statistics advance alike."""
    for r in session:
        part = r["non_finite"]
        before, after = part["before"], part["after"]
        assert not np.isfinite(float(part["metrics"]["loss"]))
        assert (after["count"], after["step"]) == (before["count"], before["step"])
        assert any(b.abs().sum() > 0 for b in before["momentum"])
        assert all(torch.equal(x, y) for x, y in zip(after["momentum"], before["momentum"]))
        for k, v in before["model"].items():
            if "running" not in k:
                assert torch.equal(after["model"][k], v), k
    _assert_replicated(*(r["non_finite"]["after"] for r in session))


def _loaders(data_root, store, process_count, batch_size=4, drop_last=True):
    files, _, _ = readers.get_color_file_names_by_bag(data_root, 1, 1, 1)
    folders = readers.get_parent_folder_names(data_root, [1, 2])
    kw = dict(image_file_names=files, folder_list=folders, adjacent_range=[1, 3],
              downsampling=4.0, network_downsampling=64, inlier_percentage=0.99,
              visible_interval=30, use_store_data=False, phase="train",
              num_pre_workers=1, num_iter=8)
    (store / "jax").mkdir()
    (store / "port").mkdir()
    want = jdataset.SfMDataset(transform=jaugment.TrainingAugmentation(seed=10085),
                               store_data_root=store / "jax",
                               use_native_rasterizer=False, **kw)
    got = dataset.SfMDataset(transform=augment.TrainingAugmentation(seed=10085),
                             store_data_root=store / "port", **kw)
    return (jdataset.BatchLoader(want, batch_size, shuffle=True, num_workers=2),
            [dataset.BatchLoader(got, batch_size, shuffle=True, num_workers=2,
                                 process_index=p, process_count=process_count,
                                 drop_last=drop_last)
             for p in range(process_count)])


def test_batch_loader_partition_matches_the_jax_global_batch(tmp_path):
    """(6) Over 2 epochs, the two processes' rows of each batch,
    concatenated, equal the JAX loader's global batch bit for bit."""
    write_sequence(tmp_path / "data", seed=3)
    want_loader, got_loaders = _loaders(tmp_path / "data", tmp_path, WORLD)
    for epoch in (0, 1):
        want_loader.set_epoch(epoch)
        for loader in got_loaders:
            loader.set_epoch(epoch)
        want = list(want_loader)
        parts = [list(loader) for loader in got_loaders]
        assert len(want) == 2 and all(len(p) == 2 for p in parts)
        for b, w in enumerate(want):
            for key, value in w.items():
                pieces = [p[b][key] for p in parts]
                if isinstance(value, list):
                    assert sum(pieces, []) == value, key
                else:
                    assert all(x.shape[0] == 2 for x in pieces), key
                    got = np.concatenate(pieces)
                    assert got.dtype == value.dtype and np.array_equal(got, value), key


class _EightSamples:
    def __len__(self):
        return 8


def test_batch_loader_refuses_an_uneven_partition():
    """(6) A batch that does not split over the processes raises, and so
    does a ragged last batch that would be split unevenly, as in JAX."""
    samples = _EightSamples()
    for package in (jdataset, dataset):
        with pytest.raises(ValueError, match="divide evenly"):
            package.BatchLoader(samples, 3, shuffle=True, process_index=0,
                                process_count=2)
        ragged = package.BatchLoader(samples, 6, shuffle=True, process_index=0,
                                     process_count=2, drop_last=False)
        with pytest.raises(ValueError, match="drop_last"):
            list(ragged)
    with pytest.raises(ValueError, match="process_index"):
        dataset.BatchLoader(samples, 4, shuffle=True, process_index=2, process_count=2)


@pytest.mark.parametrize("batch_size,world", [(3, 2), (8, 3), (6, 4)])
def test_check_batch_divides_raises(batch_size, world):
    """(7)"""
    with pytest.raises(ValueError, match="divisible"):
        distributed.check_batch_divides(batch_size, world)
    distributed.check_batch_divides(batch_size * world, world)


def test_no_collective_without_a_process_group():
    """World size 1: the collectives return their input untouched and
    ``average_gradients`` returns the gradients themselves."""
    assert distributed.group() is None and distributed.world() == 1
    assert distributed.is_main()
    t = torch.arange(4.0)
    assert distributed.all_mean_(t) is t and distributed.all_sum_(t) is t
    grads = [torch.ones(2), torch.zeros(3)]
    assert all(a is b for a, b in zip(distributed.average_gradients(grads), grads))


def test_a_failing_rank_ends_both_processes(inputs, tmp_path):
    """(8) Rank 1 raises between its forward and its backward while rank 0
    waits in the backward's collectives: both processes exit non-zero
    well inside the group's timeout, and rank 1's traceback is in its
    stderr."""
    arch, state_dict, batch = inputs["step"]
    codes, errs, _ = ranks.run_ranks(ranks.fail_mid_step, WORLD, tmp_path,
                                     arch, state_dict, batch, timeout=90)
    assert all(c != 0 for c in codes), (codes, errs)
    assert "Traceback" in errs[1] and "fault injected on rank 1" in errs[1], errs[1]
    assert "fault injected" not in errs[0]
