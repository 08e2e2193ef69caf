"""The train step's CUDA graph (``step_graph``) on the card: replayed steps
against eager ones, bit for bit, the counters, the spans and the graph's
memory.

Marked ``cuda``: needs a CUDA device, and skips without one (decided in a
fixture, so every worker collects the same tests). Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_step_graph.py
"""
import copy
import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from endoscopydepthestimation_pytorch_tpu_torch import step_graph, training
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet57, UNet, init_weights
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything as dav2
from endoscopydepthestimation_pytorch_tpu_torch.ops import block_engine, sgd_update, warp_sample
from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

BF16 = training.TrainConfig(lr_step_size=4, compute_dtype=torch.bfloat16)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class Eager(step_graph.CudaGraphs):
    """The card's backend, engaging nowhere: every step runs as before
    graphs, on the caller's stream."""

    def engages(self, device):
        return False


def _seeded(model, seed=0):
    return init_weights(model, torch.Generator().manual_seed(seed))


def _dav2_four_blocks():
    """Depth Anything V2-Large cut to the four blocks its DPT head reads."""
    model = _seeded(dav2.DepthAnythingV2(depth=4, layer_idx=(0, 1, 2, 3),
                                         dtype=torch.bfloat16))
    with torch.no_grad():  # depth = relu(3 + 0.1 conv): away from the 1/z pole
        head = model.depth_head.scratch.output_conv2[2]
        head.weight.mul_(0.1)
        head.bias.fill_(3.0)
    return model


# builder, batch, height, width
CASES = {
    "fcdn57_engine": (lambda: chip_smoke.conditioned(_seeded(FCDenseNet57(
        dtype=torch.bfloat16))), 2, 128, 160),
    "unet": (lambda: chip_smoke.conditioned_unet(_seeded(UNet(dtype=torch.bfloat16))),
             2, 128, 160),
    "act8": (lambda: chip_smoke.conditioned(_seeded(FCDenseNet57(
        dtype=torch.bfloat16, act8=True))), 2, 128, 160),
    "remat": (lambda: chip_smoke.conditioned(_seeded(FCDenseNet57(
        dtype=torch.bfloat16, remat=True))), 2, 128, 160),
}
DCLS = [0.1, 0.1, 5.0, 5.0]


def _written(state):
    return [*state.params, *state.momentum, *state.model.buffers(), state.count,
            state.step]


def _steps(state, batches, device):
    """A step a batch, the metrics kept as returned and read at the end."""
    kept = []
    for batch, dcl in zip(batches, DCLS):
        _, metrics = training.train_step(state, batch, torch.tensor(dcl, device=device), BF16)
        kept.append(metrics)
    torch.cuda.synchronize()
    return kept


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_steps_equal_eager_steps_bitwise(device, monkeypatch, case):
    """Four steps (eager, capture and replay, replay, replay; DCL's weight
    changed at the third) against four eager ones: parameters, momentum,
    running statistics, count, step and every step's metrics, read after
    the last step."""
    build, b, h, w = CASES[case]
    model = build()
    batches = [chip_smoke.synthetic_batch(b, h, w, seed, device) for seed in (1, 2, 3, 4)]
    eager = training.create_train_state(copy.deepcopy(model).to(device))
    graphed = training.create_train_state(model.to(device))
    with monkeypatch.context() as m:
        m.setattr(step_graph, "BACKEND", Eager())
        want = _steps(eager, batches, device)
    before = dict(step_graph.GRAPHED)
    got = _steps(graphed, batches, device)
    assert {k: step_graph.GRAPHED[k] - before[k] for k in before} == {
        "eager": 1, "captures": 1, "replays": 3}
    assert int(graphed.step) == 4
    for a, b_ in zip(_written(graphed), _written(eager)):
        assert torch.equal(a, b_)
    for i, (a, b_) in enumerate(zip(got, want)):
        assert a.keys() == b_.keys()
        for k in a:
            assert torch.equal(a[k], b_[k]), (i, k)
    assert all(torch.isfinite(m["loss"]) for m in got)


def test_a_dav2_replay_computes_what_an_eager_step_computes(device, monkeypatch):
    """Depth Anything V2's eager step is not bitwise repeatable itself (the
    bilinear resizes' backward and attention's backward sum with atomics),
    so from one state a replay's loss terms (the forward's) equal an eager
    step's bit for bit, and its update lies as near an eager step's as a
    second eager step's does, or within 0.1% of the update's norm."""
    graphed = training.create_train_state(_dav2_four_blocks().to(device))
    batches = [chip_smoke.synthetic_batch(1, 252, 322, seed, device) for seed in (1, 2, 3)]
    dcl = torch.tensor(0.1, device=device)
    for batch in batches[:2]:  # eager, then the capture and its replay
        training.train_step(graphed, batch, dcl, BF16)
    torch.cuda.synchronize()
    eager = []
    for _ in range(2):
        state = training.create_train_state(copy.deepcopy(graphed.model))
        with torch.no_grad():
            for a, b in zip([*state.momentum, state.count, state.step],
                            [*graphed.momentum, graphed.count, graphed.step]):
                a.copy_(b)
        eager.append(state)
    start = [p.detach().clone() for p in graphed.params]
    before = dict(step_graph.GRAPHED)
    _, got = training.train_step(graphed, batches[2], dcl, BF16)
    assert step_graph.GRAPHED["replays"] == before["replays"] + 1
    with monkeypatch.context() as m:
        m.setattr(step_graph, "BACKEND", Eager())
        want = [training.train_step(state, batches[2], dcl, BF16)[1] for state in eager]
    torch.cuda.synchronize()
    for k in ("loss", "sparse_flow_loss", "depth_consistency_loss", "scale_std"):
        assert torch.equal(got[k], want[0][k]) and torch.equal(want[1][k], want[0][k]), k

    def update(state):
        return torch.cat([(p.detach() - s).flatten() for p, s in zip(state.params, start)])

    graph_update, first, second = update(graphed), update(eager[0]), update(eager[1])
    gap, spread = (graph_update - first).norm(), (second - first).norm()
    print(f"update norm {float(first.norm()):.6e}: replay - eager {float(gap):.6e}, "
          f"eager - eager {float(spread):.6e}")
    assert gap <= 2 * spread + 1e-3 * first.norm()
    for a, b in zip(graphed.model.buffers(), eager[0].model.buffers()):
        assert torch.equal(a, b)
    assert (int(graphed.count), int(graphed.step)) == (int(eager[0].count), 3)


def test_a_replay_is_one_span_and_the_trace_sees_its_kernels(device):
    """Under ``torch.profiler`` recording the device alone, as the
    benchmark's traced stretch does, a replayed FCDenseNet-57 step is one
    ``replay`` phase with no span inside, and the trace holds its K4-K6,
    K2, K3 and optimizer kernels; the counters move by one step's."""
    model = chip_smoke.conditioned(_seeded(FCDenseNet57(dtype=torch.bfloat16)))
    state = training.create_train_state(model.to(device))
    batch = chip_smoke.synthetic_batch(2, 128, 160, 5, device)
    dcl = torch.tensor(0.1, device=device)
    for _ in range(2):  # eager, then the capture
        training.train_step(state, batch, dcl, BF16)
    torch.cuda.synchronize()
    counts = (dict(block_engine.LAUNCHES), dict(warp_sample.LAUNCHES),
              sgd_update.LAUNCHES["sgd_update"])
    with profiling.root_span("idle"):
        pass
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            training.train_step(state, batch, dcl, BF16)
        torch.cuda.synchronize()
    session = profiling.sessions()[-1]
    assert sorted(r.name for r in session.records) == ["replay", "replay", "train_step",
                                                       "train_step"]
    assert {k: v - counts[0][k] for k, v in block_engine.LAUNCHES.items()} == {
        **dict.fromkeys(block_engine.LAUNCHES, 88), "block_engine_entry": 22,
        "block_engine_exit": 22, "block_engine_glue_fwd": 110, "block_engine_glue_bwd": 110,
        "block_engine_running_stats": 22}
    assert {k: v - counts[1][k] for k, v in warp_sample.LAUNCHES.items()} == dict.fromkeys(
        warp_sample.LAUNCHES, 2)
    assert sgd_update.LAUNCHES["sgd_update"] == counts[2] + 2
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert sum("dinput_mma_kernel" in n for n in names) == 88, sorted(set(names))
    assert sum("warp_sample_fwd_kernel" in n for n in names) == 2
    assert sum("sgd_step_kernel" in n for n in names) == 2


def _rise(run) -> int:
    """The allocator's peak over ``run()`` above what was allocated before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def test_graphed_steps_hold_no_memory_beyond_the_static_inputs(device):
    """Three graphed FCDenseNet-57 b8 256x320 steps (eager, capture and
    replay, replay) peak above three eager steps by no more than the
    graph's static inputs and packed metrics: the capture's cuBLAS
    workspaces stay in the graph's pool."""
    batch = chip_smoke.synthetic_batch(8, 256, 320, 7, device)
    dcl = torch.tensor(0.1, device=device)

    def fresh():
        model = chip_smoke.conditioned(_seeded(FCDenseNet57(dtype=torch.bfloat16)))
        return training.create_train_state(model.to(device))

    def eager_steps():
        for _ in range(3):
            training._train_step(state, batch, dcl, BF16, False, 1)

    def graphed_steps():
        for _ in range(3):
            training.train_step(state, batch, dcl, BF16)

    state = fresh()
    eager = _rise(eager_steps)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    state = fresh()
    graphed = _rise(graphed_steps)
    blocks = [v.nbytes for v in batch.values()] + [dcl.nbytes, 4 * 6]
    static = sum(-(-n // 512) * 512 for n in blocks)
    assert graphed - eager <= static, (graphed, eager, static)
