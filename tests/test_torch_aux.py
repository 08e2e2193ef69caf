"""The port's aux paths against the JAX package's, on the CPU in f32:
failure detection and model selection (``failure.py``), the standalone
validation (``validation.py``), distillation (``distill.py``) and the
rest of ``utils/visualization.py``. Twins of tests/test_aux.py's cases.

FCDenseNet-57 runs at full width, 64x64 B=2, from seeded JAX weights
(``from_jax_variables``) with the head conditioned as in
tests/test_torch_training.py (x0.1, bias +3): the SFL and the log ratio
of the SI loss amplify f32 order noise at a raw init. The validation's
losses are held at rtol 1e-4; the distillation step at the train-step
tolerances (loss rtol 1e-4, new parameters and momentum rtol 1e-4 /
atol 1e-5, new BN statistics rtol 1e-4 / atol 1e-5).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu import distill as jdistill
from endoscopydepthestimation_pytorch_tpu import failure as jfailure
from endoscopydepthestimation_pytorch_tpu import training as jtraining
from endoscopydepthestimation_pytorch_tpu import validation as jvalidation
from endoscopydepthestimation_pytorch_tpu.models import FCDenseNet57 as JaxFCDenseNet57
from endoscopydepthestimation_pytorch_tpu.utils import visualization as jviz
from endoscopydepthestimation_pytorch_tpu_torch import distill, failure, training, validation
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet57, init_weights
from endoscopydepthestimation_pytorch_tpu_torch.utils import visualization as viz

from test_torch_training import _conditioned, _named_jax, _port_model, _to_torch
from test_training import _synthetic_batch
from torch_port_cases import seeded_jax_state

# -- failure detection and model selection --------------------------------------


def _outlier_case(seed):
    rng = np.random.RandomState(seed)
    flows = rng.randn(4, 8, 8, 2).astype(np.float32)
    pred = flows + rng.randn(4, 8, 8, 2).astype(np.float32) * 0.1
    pred[2] += 5.0  # one very wrong sample
    masks = (rng.rand(4, 8, 8, 1) > 0.3).astype(np.float32)
    return flows, pred, masks


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_outlier_batches_and_worst_sample_match_jax(seed):
    flows, pred, masks = _outlier_case(seed)
    want_idx, want = jfailure.detect_outlier_batches(flows, pred, masks, 1.0)
    got_idx, got = failure.detect_outlier_batches(torch.from_numpy(flows), pred, masks, 1.0)
    assert got_idx == want_idx == [2]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    folders = ["a", "b", "c", "d"]
    # the report on the same per-sample vectors
    assert failure.worst_sample_report(torch.tensor(want), want[::-1].copy(), folders) == \
        jfailure.worst_sample_report(want, want[::-1].copy(), folders)
    assert failure.worst_sample_report(want, want, []) == \
        jfailure.worst_sample_report(want, want, [])


_PREV = [1.0, 1.0, 1.0, 1.0]
DELTA_CASES = [
    ([0.9] * 4, _PREV), ([1.1] * 4, _PREV), ([0.2, 1.05, 1.05, 1.05], _PREV),
    ([0.9, 1.2, 1.2, 1.2], _PREV), ([1, 2], [1]), ([1], [1, 2]), ([1.0, 2.0], [1.0, 2.0]),
    (list(np.random.RandomState(5).rand(9)), list(np.random.RandomState(6).rand(9))),
]


@pytest.mark.parametrize("new,old", DELTA_CASES)
def test_outlier_robust_validation_loss_delta_matches_jax(new, old):
    assert failure.outlier_robust_validation_loss_delta(
        torch.tensor(new, dtype=torch.float64), old) == \
        jfailure.outlier_robust_validation_loss_delta(new, old)


@pytest.mark.parametrize("new,best,only", [
    ([1.0, 1.0], [2.0, 2.0], True), ([3.0, 3.0], [2.0, 2.0], True),
    ([3.0, 3.0], [2.0, 2.0], False), ([1.0, 1.0, 1.0], [2.0, 2.0], True)])
def test_save_if_best_matches_jax(tmp_path, new, best, only):
    """The same paths written, in the same order, and the same vector kept."""
    results = []
    for package in (jfailure, failure):
        written = []
        kept = package.save_if_best(lambda p: written.append(str(p)), tmp_path,
                                    tmp_path / "best", "3", new, best, save_best_only=only)
        results.append((written, np.asarray(kept)))
    (want_paths, want), (got_paths, got) = results
    assert got_paths == want_paths
    np.testing.assert_array_equal(got, want)


# -- the standalone validation -------------------------------------------------


@pytest.fixture(scope="module")
def jax57():
    return _conditioned(seeded_jax_state(JaxFCDenseNet57(n_classes=1), (1, 64, 64, 3),
                                         seed=11))


def _validation_batches():
    batches = [_synthetic_batch(seed=s) for s in range(4)]
    batches[2]["color_1"][0, 32, 32, 0] = np.nan  # a NaN batch, skipped by both
    return batches


def _scalars(log_dir):
    return [json.loads(line) for line in (log_dir / "scalars.jsonl").read_text().splitlines()]


def test_network_validation_matches_jax(jax57, tmp_path):
    """The per-batch vector (the NaN batch skipped by both), its mean and
    the writer's three "Validation" scalars at rtol 1e-4; the model is
    left in train mode, as it was."""
    batches = _validation_batches()
    jwriter = jviz.MetricWriter(tmp_path / "jax")
    want_mean, want = jvalidation.network_validation(jax57, batches, writer=jwriter, epoch=2)
    jwriter.close()
    state = training.create_train_state(_port_model(jax57, FCDenseNet57()).train())
    writer = viz.MetricWriter(tmp_path / "port")
    got_mean, got = validation.network_validation(state, batches, writer=writer, epoch=2)
    writer.close()
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-4)
    assert state.model.training
    (w,), (g,) = _scalars(tmp_path / "jax"), _scalars(tmp_path / "port")
    assert sorted(g) == sorted(w) and (g["tag"], g["step"]) == (w["tag"], w["step"])
    for key in ("overall", "depth consistency", "sparse opt"):
        np.testing.assert_allclose(g[key], w[key], rtol=1e-4)


def test_validation_step_matches_jax(jax57):
    """One batch's three weighted losses, with a boundary that is not
    binary (the 0.9 threshold applies)."""
    batch = _synthetic_batch(seed=12)
    batch["boundary"] = batch["boundary"] * np.float32(0.95)
    batch["boundary"][:, 8:12] = 0.5
    want = jax.jit(jvalidation.validation_step)(
        jax57, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(20.0),
        jnp.float32(5.0))
    state = training.create_train_state(_port_model(jax57, FCDenseNet57()))
    got = validation.validation_step(state, _to_torch(batch))
    for key in ("loss", "sparse_flow_loss", "depth_consistency_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=key)


# -- distillation ------------------------------------------------------------------


def _distill_batch(seed=13, h=64, w=64):
    b = _synthetic_batch(seed=seed, h=h, w=w)
    return {k: b[k] for k in ("color_1", "color_2", "boundary")}


def _jax_momentum(jstate, stats):
    return _named_jax(jstate.opt_state.inner_state[1][0].trace, stats)


@pytest.fixture(scope="module")
def distill_case(jax57):
    """A conditioned teacher (``jax57``) and student (another seed), JAX's
    jitted ``distill_step`` and its result on a finite batch."""
    student = _conditioned(seeded_jax_state(JaxFCDenseNet57(n_classes=1), (1, 64, 64, 3),
                                            seed=14))
    step = jax.jit(lambda s, t, b: jdistill.distill_step(s, t, b, jtraining.TrainConfig()))
    batch = _distill_batch()
    jnew, jm = step(jax.tree.map(jnp.array, student), jax57,
                    {k: jnp.asarray(v) for k, v in batch.items()})
    return student, step, batch, jnew, jm


def _port_distill(jteacher, jstudent, batch):
    teacher = training.create_train_state(_port_model(jteacher, FCDenseNet57()))
    student = training.create_train_state(_port_model(jstudent, FCDenseNet57()))
    teacher_before = {k: v.clone() for k, v in teacher.model.state_dict().items()}
    was_training = teacher.model.training
    student, metrics = distill.distill_step(student, teacher, _to_torch(batch),
                                            training.TrainConfig())
    assert teacher.model.training == was_training  # left in the mode it was in
    assert all(torch.equal(teacher.model.state_dict()[k], v)
               for k, v in teacher_before.items())  # the teacher never moves
    return student, metrics


def test_distill_step_matches_jax(jax57, distill_case):
    """One step: the loss, the new parameters, momentum and BN statistics
    (moved once) against JAX's ``distill_step``."""
    jstudent, _, batch, jnew, jm = distill_case
    student, metrics = _port_distill(jax57, jstudent, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-4)
    assert float(metrics["finite"]) == float(jm["finite"]) == 1.0
    assert int(student.step) == int(jnew.step) == 1
    want = _named_jax(jnew.params, jnew.batch_stats)
    got = student.model.state_dict()
    for k, v in want.items():
        if "num_batches_tracked" not in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    momentum = _jax_momentum(jnew, jnew.batch_stats)
    for (name, _), b in zip(student.model.named_parameters(), student.momentum):
        np.testing.assert_allclose(b.numpy(), momentum[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_distill_non_finite_loss_keeps_the_student_as_jax(jax57, distill_case):
    """Sample 0's empty boundary makes its SI loss 0/0: no update, ``step``
    and ``count`` stay, the momentum stays zero; the BN statistics still
    move (the forward ran), as in JAX."""
    jstudent, step, batch, _, _ = distill_case
    boundary = batch["boundary"].copy()
    boundary[0] = 0.0
    batch = dict(batch, boundary=boundary)
    jnew, jm = step(jax.tree.map(jnp.array, jstudent), jax57,
                    {k: jnp.asarray(v) for k, v in batch.items()})
    student, metrics = _port_distill(jax57, jstudent, batch)
    assert not np.isfinite(float(metrics["loss"])) and not np.isfinite(float(jm["loss"]))
    assert float(metrics["finite"]) == float(jm["finite"]) == 0.0
    assert int(student.step) == int(jnew.step) == 0 and int(student.count) == 0
    assert all(float(b.abs().max()) == 0.0 for b in student.momentum)
    momentum = _jax_momentum(jnew, jnew.batch_stats)
    assert all(float(np.abs(v.numpy()).max()) == 0.0 for k, v in momentum.items()
               if "running" not in k and "num_batches" not in k)
    want = _named_jax(jnew.params, jnew.batch_stats)
    got = student.model.state_dict()
    for k, v in want.items():
        if "num_batches_tracked" not in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_distill_step_converges_toward_teacher():
    """JAX's test: six steps from two raw inits at 32x32 B=2 (lr_step_size
    50), finite, the last loss below the first."""
    config = training.TrainConfig(lr_step_size=50)
    teacher = training.create_train_state(
        init_weights(FCDenseNet57(), torch.Generator().manual_seed(0)))
    student = training.create_train_state(
        init_weights(FCDenseNet57(), torch.Generator().manual_seed(1)))
    rng = np.random.RandomState(0)
    batch = {"color_1": torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
             "color_2": torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
             "boundary": torch.ones(2, 32, 32, 1)}
    seen = []
    for _ in range(6):
        student, metrics = distill.distill_step(student, teacher, batch, config)
        seen.append(float(metrics["loss"]))
    assert np.isfinite(seen).all() and seen[-1] < seen[0], seen


# -- visualization -----------------------------------------------------------------


@pytest.mark.parametrize("size", [101, 64])
def test_flow_color_wheel_matches_jax(size):
    np.testing.assert_array_equal(viz.flow_color_wheel(size), jviz.flow_color_wheel(size))


def test_display_helpers_write_jaxs_pngs(tmp_path):
    rng = np.random.RandomState(4)
    colors = rng.uniform(-1, 1, (3, 12, 16, 3)).astype(np.float32)
    depths = np.abs(rng.randn(3, 12, 16, 1)).astype(np.float32)
    for name, package, images, ds in (("jax", jviz, colors, depths),
                                      ("port", viz, torch.from_numpy(colors),
                                       torch.from_numpy(depths))):
        out = tmp_path / name
        package.visualize_color_image("color", images, rebias=True, save_dir=out)
        package.visualize_color_image("hsv", images, rebias=True, is_hsv=True,
                                      idx_list=[1], save_dir=out)
        assert package.visualize_depth_map("depth", ds, save_dir=out) == \
            (float(depths.min()), float(depths.max()))
        package.visualize_depth_map("ranged", ds, 0.2, 1.5, idx_list=[0, 2], save_dir=out)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 9
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    np.testing.assert_array_equal(viz.display_depth_map(torch.from_numpy(depths[0])),
                                  jviz.display_depth_map(depths[0]))
    np.testing.assert_array_equal(viz.display_depth_map(depths[1], 0.0, 2.0),
                                  jviz.display_depth_map(depths[1], 0.0, 2.0))


class _Histograms:
    def __init__(self):
        self.calls = []

    def add_histogram(self, tag, values, step):
        self.calls.append((tag, np.asarray(values), step))

    def close(self):
        pass


def test_weight_histograms_match_jax(jax57, tmp_path):
    """One histogram per parameter, of its values, at the step; the same
    multiset of values as JAX's over its parameter tree; nothing without
    tensorboardX."""
    model = _port_model(jax57, FCDenseNet57())
    recorded = {}
    for name, package, params in (("jax", jviz, jax57.params), ("port", viz, model)):
        writer = package.MetricWriter(tmp_path / name)
        writer._tb = _Histograms()
        package.weight_histograms(params, writer, step=5)
        recorded[name] = writer._tb.calls
        writer._tb = None
        writer.close()
    port, jax_calls = recorded["port"], recorded["jax"]
    assert [t for t, _, _ in port] == [f"Weights/{n}" for n, _ in model.named_parameters()]
    assert all(s == 5 for _, _, s in port)
    for (_, values, _), (_, p) in zip(port, model.named_parameters()):
        np.testing.assert_array_equal(values, p.detach().numpy().ravel())
    assert sorted((v.size, round(float(np.sort(v).sum()), 3)) for _, v, _ in port) == \
        sorted((v.size, round(float(np.sort(v).sum()), 3)) for _, v, _ in jax_calls)
    writer = viz.MetricWriter(tmp_path / "none")
    writer._tb = None
    viz.weight_histograms(model, writer, step=0)  # no tensorboardX: nothing to do
    writer.close()
