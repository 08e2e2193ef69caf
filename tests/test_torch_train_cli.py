"""The port's trainer (``python -m
endoscopydepthestimation_pytorch_tpu_torch.train``) on the CPU: FCDenseNet-57
at 64x64, b2, 2 steps an epoch, epochs 0 and 1, on a seeded synthetic SfM
sequence (tests/torch_sfm_sequence.py), then a resume from the epoch-0
checkpoint. The resumed epoch 1 must end where the first run's epoch 1
ended, bit for bit: the checkpoint restores the model, the momentum,
``count`` and ``step`` exactly, and each epoch's batches depend only on the
seed and the epoch. The JAX package's ``load_any_checkpoint`` reads the
port's ``.pt``; ``--remat`` and ``--act8`` train an epoch; each flag the
port does not carry raises.
"""
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu import training as jtraining
from endoscopydepthestimation_pytorch_tpu.models import FCDenseNet57 as JaxFCDenseNet57
from endoscopydepthestimation_pytorch_tpu.utils import checkpoint as jckpt
from endoscopydepthestimation_pytorch_tpu.utils import visualization as jviz
from endoscopydepthestimation_pytorch_tpu_torch import train, training
from endoscopydepthestimation_pytorch_tpu_torch.models import (FCDenseNet57, from_jax_variables,
                                                                 init_weights)
from endoscopydepthestimation_pytorch_tpu_torch.utils import checkpoint as ckpt
from endoscopydepthestimation_pytorch_tpu_torch.utils import visualization as viz

from torch_parallel_ranks import free_port
from torch_sfm_sequence import write_sequence

REPO = Path(__file__).resolve().parents[1]


def _argv(data_root, result_root, *extra):
    return ["--adjacent_range", "1", "3", "--id_range", "1", "2",
            "--input_size", "64", "64", "--batch_size", "2", "--num_iter", "4",
            "--number_epoch", "1", "--display_interval", "1", "--log_interval", "1",
            "--num_workers", "2", "--num_pre_workers", "1",
            "--training_patient_id", "1", "--testing_patient_id", "1",
            "--validation_patient_id", "1", "--compute_dtype", "float32",
            "--training_data_root", str(data_root),
            "--training_result_root", str(result_root), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The first run (epochs 0 and 1) and the resume from its epoch-0
    checkpoint (epoch 1)."""
    root = tmp_path_factory.mktemp("cli")
    write_sequence(root / "data", seed=7)
    first = train.main(_argv(root / "data", root / "first"))
    resumed = train.main(_argv(root / "data", root / "resumed", "--load_trained_model",
                               "--trained_model_path", str(first.checkpoints[0])))
    return first, resumed


def test_cli_writes_checkpoints_scalars_and_boards(runs):
    first, _ = runs
    root = first.log_root
    assert root.name.startswith("depth_estimation_train_run_") and root.name.endswith("_test_id_1")
    assert [p.name.split("_validation_")[0] for p in first.checkpoints] == [
        "checkpoint_model_epoch_0", "checkpoint_model_epoch_1"]
    assert all(p.exists() and p.suffix == ".pt" for p in first.checkpoints)
    records = [json.loads(line) for line in (root / "scalars.jsonl").read_text().splitlines()]
    tags = [r["tag"] for r in records]
    assert tags.count("Training") == 2 and tags.count("Validation") == 2  # 1 of 2 steps late
    for epoch in (0, 1):
        exported = json.loads((root / f"all_scalars_{epoch}.json").read_text())
        assert set(exported) == {"Training", "Validation"}
    assert len(list(root.glob("Training_Images_Results_*.png"))) == 4  # every step
    assert list(root.glob("Validation_Images_Results_*.png"))
    assert len(first.losses) == 4 and np.isfinite(first.losses).all()


def test_checkpoint_holds_the_state(runs):
    """The epoch-0 file: the model with the ``module.`` prefix, a momentum
    buffer per parameter, ``count`` and ``step`` after 2 steps, the epoch
    to resume at; loading it restores them exactly."""
    first, _ = runs
    raw = torch.load(first.checkpoints[0], weights_only=True)
    assert sorted(raw) == ["epoch", "model", "optimizer", "step", "validation"]
    assert raw["epoch"] == 1 and raw["step"] == 2
    assert all(k.startswith("module.") for k in raw["model"])
    (group,) = raw["optimizer"]["param_groups"]
    assert group["count"] == 2
    model = FCDenseNet57()
    n_params = len(list(model.parameters()))
    assert sorted(raw["optimizer"]["state"]) == list(range(n_params))
    state, epoch, validation = ckpt.load_checkpoint(first.checkpoints[0],
                                                    training.create_train_state(model))
    assert (epoch, validation) == (1, raw["validation"])
    assert int(state.step) == int(state.count) == 2
    assert any(b.abs().sum() > 0 for b in state.momentum)
    for i, b in enumerate(state.momentum):
        assert torch.equal(b, raw["optimizer"]["state"][i]["momentum_buffer"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, raw["model"][f"module.{k}"]), k


def test_resume_ends_where_the_first_run_ended(runs):
    """Epoch 1 of the resumed run reproduces epoch 1 of the first run bit
    for bit: weights, BN statistics, momentum, count and step."""
    first, resumed = runs
    assert len(resumed.checkpoints) == 1
    assert resumed.losses == first.losses[2:]
    want = torch.load(first.checkpoints[1], weights_only=True)
    got = torch.load(resumed.checkpoints[0], weights_only=True)
    assert got["step"] == want["step"] == 4 and got["epoch"] == want["epoch"] == 2
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, s in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][i]["momentum_buffer"],
                           s["momentum_buffer"]), i


def test_jax_package_reads_the_ports_checkpoint(runs):
    """The JAX ``load_any_checkpoint`` reads the port's ``.pt``: its weights
    come back to the port unchanged, and its step."""
    first, _ = runs
    template = jax.eval_shape(lambda: jtraining.create_train_state(
        JaxFCDenseNet57(n_classes=1), jax.random.PRNGKey(0), (1, 64, 64, 3),
        jtraining.TrainConfig()))
    state, epoch, validation = jckpt.load_any_checkpoint(first.checkpoints[1], template)
    raw = torch.load(first.checkpoints[1], weights_only=True)
    assert (int(state.step), epoch, validation) == (4, 2, raw["validation"])
    back = from_jax_variables(jax.tree.map(np.asarray, state.params),
                              jax.tree.map(np.asarray, state.batch_stats))
    assert sorted(back) == sorted(k.removeprefix("module.") for k in raw["model"])
    for k, v in back.items():
        if "num_batches_tracked" not in k:
            assert torch.equal(v, raw["model"][f"module.{k}"]), k


@pytest.mark.parametrize("flag", [
    ["--fused_convs"], ["--segmented_last_up"],
    ["--no-segmented_last_up"], ["--split_last_skip"], ["--no-split_last_skip"]],
    ids=["flag0", "flag3", "flag4", "flag5", "flag6"])  # the ids before --remat/--act8 went
def test_flags_not_ported_raise(tmp_path, flag):
    """Each flag for what the port does not carry raises, naming its
    ROADMAP item, before anything is read or written."""
    with pytest.raises(ValueError, match="ROADMAP"):
        train.main(_argv(tmp_path / "data", tmp_path / "out", *flag))
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("flag", ["--remat", "--act8"])
def test_remat_and_act8_train_an_epoch(runs, tmp_path, flag):
    """Epoch 0 (2 steps, validation, a checkpoint) from the first run's seed
    and data with ``--remat`` or ``--act8``: remat's losses are the first
    run's bit for bit; act8's first loss is (its forward is exact) and its
    second is finite; the checkpoint loads back into a plain model."""
    first, _ = runs
    data = first.log_root.parents[1] / "data"
    run = train.main(_argv(data, tmp_path / "out", flag, "--number_epoch", "0"))
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    if flag == "--remat":
        assert run.losses == first.losses[:2]
    else:
        assert run.losses[0] == first.losses[0]
    (path,) = run.checkpoints
    state, epoch, _ = ckpt.load_checkpoint(path, training.create_train_state(FCDenseNet57()))
    assert epoch == 1 and int(state.step) == int(state.count) == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, run.state.model.state_dict()[k]), k


@pytest.mark.parametrize("flag", [
    ["--coordinator_address", "localhost:1234"],
    ["--num_processes", "2"], ["--process_id", "0"]])
def test_distributed_flags_need_each_other(tmp_path, flag):
    """One of the three data-parallel flags without the other two raises
    before anything is read or written."""
    with pytest.raises(ValueError, match="together"):
        train.main(_argv(tmp_path / "data", tmp_path / "out", *flag))
    assert not (tmp_path / "out").exists()


def test_block_engine_flag_is_accepted():
    args = train.build_parser().parse_args(_argv("d", "r", "--block_engine"))
    train._refuse_unported(args)
    assert args.block_engine and args.device == "cpu"


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """``--device`` defaults to cuda, and without a card the trainer raises
    rather than fall back to the CPU."""
    argv = _argv(tmp_path / "data", tmp_path / "out")[:-2]
    assert train.build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(argv)


def test_write_event_writes_the_jax_record():
    """One sorted-key JSON line with the data, ``step`` and a ``dt``
    stamp, as the JAX package's ``write_event`` writes it."""
    got, want = io.StringIO(), io.StringIO()
    viz.write_event(got, 3, loss=0.5, sfl=0.25)
    jviz.write_event(want, 3, loss=0.5, sfl=0.25)
    g, w = json.loads(got.getvalue()), json.loads(want.getvalue())
    assert got.getvalue().endswith("\n") and list(g) == list(w) == sorted(w)
    assert {k: v for k, v in g.items() if k != "dt"} == {k: v for k, v in w.items() if k != "dt"}


def test_metric_writer_logs_on_when_tensorboardx_is_broken(tmp_path, monkeypatch):
    """An installed tensorboardX that fails to import with another error
    than ImportError leaves the writer on JSONL and PNG, as the JAX
    package's writer does, instead of stopping the run."""
    import builtins
    real_import = builtins.__import__

    def broken(name, *args, **kwargs):
        if name == "tensorboardX":
            raise RuntimeError("tensorboardX is installed but broken")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", broken)
    writer = viz.MetricWriter(tmp_path)
    assert writer._tb is None
    writer.add_scalars("Training", {"overall": 0.5}, 3)
    writer.add_image("Training/Images/Results", np.zeros((4, 6, 3), np.float32), 3)
    writer.close()
    (record,) = [json.loads(line) for line in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert record == {"tag": "Training", "step": 3, "overall": 0.5}
    assert (tmp_path / "Training_Images_Results_3.png").exists()


def _trainer_process(argv, out: Path, *extra) -> subprocess.Popen:
    """The trainer CLI in a process of its own, two threads."""
    return subprocess.Popen(
        [sys.executable, "-m", "endoscopydepthestimation_pytorch_tpu_torch.train", *argv,
         "--training_result_root", str(out), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "2"})


def _communicate(procs, timeout: float = 600):
    """Every process's (exit code, stdout, stderr); all are killed when one
    outlives ``timeout``."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a trainer process ran past {timeout} s")
    return [(p.returncode, *o) for p, o in zip(procs, outs)]


def _final_loss(stdout: str) -> float:
    found = re.findall(r"epoch 0 final loss ([0-9.]+)", stdout)
    assert found, stdout[-2000:]
    return float(found[-1])


def test_two_process_cli_matches_single_process(tmp_path):
    """The twin of the JAX package's tests/test_multihost_cli.py: the
    trainer as 2 processes (gloo on the CPU, 2 rows each of a global batch
    of 4) ends its epoch at the loss of one process at batch 4, at 64x64
    f32 with validation, both from one conditioned start. The single
    process writes the precompute, the pair loads it. Only rank 0 prints its loss and writes logs and
    checkpoints; both exit 0."""
    write_sequence(tmp_path / "data", seed=7)
    # the trainer's seeded init, its head conditioned as the step tests do
    # (test_torch_training.py: at a raw init the objective amplifies f32
    # order noise, here from convolutions at batch 8 against 4, ~1000x)
    model = init_weights(FCDenseNet57(), torch.Generator().manual_seed(train.SEED))
    with torch.no_grad():
        model.finalConv.weight.mul_(0.1)
        model.finalConv.bias.mul_(0.1).add_(3.0)
    ckpt.save_checkpoint(tmp_path / "start.pt", training.create_train_state(model), 0, 0.0)
    # each process's --training_result_root comes last and wins
    argv = _argv(tmp_path / "data", tmp_path / "unused", "--batch_size", "4",
                 "--number_epoch", "0", "--load_trained_model",
                 "--trained_model_path", str(tmp_path / "start.pt"))
    (code, out, err), = _communicate([_trainer_process(argv, tmp_path / "single")])
    assert code == 0, err[-3000:]
    port = free_port()
    pair = _communicate([_trainer_process(
        argv, tmp_path / f"multi_{rank}", "--coordinator_address", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(rank), "--load_intermediate_data")
        for rank in range(2)])
    assert [c for c, _, _ in pair] == [0, 0], "\n".join(e[-3000:] for _, _, e in pair)
    np.testing.assert_allclose(_final_loss(pair[0][1]), _final_loss(out), rtol=0, atol=5e-5)
    assert "final loss" not in pair[1][1] and pair[1][1] == "", pair[1][1]  # prints nothing
    assert list((tmp_path / "multi_0").glob("*/checkpoint_model_epoch_0_*.pt"))
    assert not (tmp_path / "multi_1").exists()
