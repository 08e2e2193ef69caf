"""The multi-tensor optimizer's CPU side (``ops/sgd_update.py``): on CPU
tensors ``training.sgd_update`` is the plain loop bit for bit; the CUDA
wrapper refuses what its kernel does not take before it loads the
library; and the layout rows the wrapper hands the kernel, read with the
kernel's own index arithmetic (``g_offset`` in ``csrc/sgd_update.cu``),
reach each gradient element of a parameter's flat offset. The kernel
itself runs in ``tests/test_torch_cuda.py`` on the card. No JAX."""
import weakref

import numpy as np
import pytest
import torch
from torch import nn

from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.ops import sgd_update

CL = torch.channels_last


class _Params(nn.Module):
    def __init__(self, tensors):
        super().__init__()
        self.ps = nn.ParameterList([nn.Parameter(t) for t in tensors])


def _state(seed, shapes=((3, 4), (5,), (2, 6, 3, 3))):
    g = torch.Generator().manual_seed(seed)
    state = training.create_train_state(
        _Params([torch.randn(s, generator=g) for s in shapes]))
    for b in state.momentum:
        b.copy_(torch.randn(b.shape, generator=g))
    state.count += 3
    state.step += 4
    return state


def _grads(seed, scale, shapes=((3, 4), (5,), (2, 6, 3, 3))):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g) * scale for s in shapes]


def _bits(state):
    return [t.clone() for t in (*state.params, *state.momentum, state.count, state.step)]


@pytest.mark.parametrize("scale,loss,bad", [
    (0.1, 1.0, None), (10.0, 1.0, None), (0.1, float("nan"), None),
    (0.1, float("inf"), None), (0.1, 1.0, float("nan")), (10.0, 1.0, float("inf"))])
def test_sgd_update_on_cpu_is_the_plain_loop_bit_for_bit(scale, loss, bad):
    """Both sides of the clip, a non-finite loss, a finite loss with a
    non-finite gradient element: the state and both results equal the
    plain loop's to the bit."""
    config = training.TrainConfig(lr_step_size=2)
    got, want = _state(0), _state(0)
    grads = _grads(1, scale)
    if bad is not None:
        grads[2][1, 4, 2, 0] = bad
    loss = torch.tensor(loss)
    finite, norm = training.sgd_update(got, loss, [g.clone() for g in grads], config)
    lr = training.make_cyclic_schedule(config.min_lr, config.max_lr,
                                       config.lr_step_size)(want.count)
    with torch.no_grad():
        finite_p, norm_p = sgd_update._sgd_update_plain(
            want.params, want.momentum, grads, loss, lr, want.count, want.step,
            config.grad_clip_norm, config.momentum)
    assert torch.equal(finite, finite_p)
    assert torch.equal(norm, norm_p) or (norm.isnan() and norm_p.isnan())
    for a, b in zip(_bits(got), _bits(want)):
        assert torch.equal(a, b)
    assert (int(got.count) == 3 + (bad is None and np.isfinite(float(loss)))
            and int(got.step) == 4 + np.isfinite(float(loss)))


def _cuda_args(params, momentum, grads):
    scalar = torch.zeros(())
    return (params, momentum, grads, scalar, scalar.clone(),
            torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32), 10.0, 0.9)


@pytest.mark.parametrize("lists,match", [
    (([torch.zeros(3)] * 2, [torch.zeros(3)] * 2, [torch.zeros(3)]), "lengths 2, 2, 1"),
    (([torch.zeros(3)], [torch.zeros(3)] * 2, [torch.zeros(3)]), "lengths 1, 2, 1"),
    (([], [], []), "lengths 0, 0, 0"),
    (([torch.zeros(3)], [torch.zeros(3)], [torch.zeros(3, dtype=torch.bfloat16)]), "float32"),
    (([torch.zeros(3, dtype=torch.float64)], [torch.zeros(3)], [torch.zeros(3)]), "float32"),
])
def test_cuda_wrapper_checks_its_arguments_before_loading(monkeypatch, lists, match):
    """Unequal lists and non-f32 tensors raise ``ValueError`` before the
    library is built or loaded (no card needed)."""
    def refuse():
        raise AssertionError("the library was loaded before the arguments were checked")
    monkeypatch.setattr(sgd_update, "_library", refuse)
    with pytest.raises(ValueError, match=match):
        sgd_update._sgd_update_cuda(*_cuda_args(*lists))


def test_cuda_wrapper_refuses_cpu_tensors(monkeypatch):
    monkeypatch.setattr(sgd_update, "_library", lambda: pytest.fail("loaded"))
    with pytest.raises(ValueError, match="one CUDA device"):
        sgd_update._sgd_update_cuda(*_cuda_args([torch.zeros(3)], [torch.zeros(3)],
                                                [torch.zeros(3)]))


def _gather(p, g):
    """g's elements read at p's flat offsets 0, 1, ... the way the kernel
    reads them: flat where ``_layout`` gives None, else through its row."""
    row = sgd_update._layout(tuple(p.shape), p.stride(), g.stride())
    assert row is not sgd_update._COPY
    flat = g.as_strided((g.numel(),), (1,))  # g's storage span, as the kernel sees it
    if row is None:
        return flat
    nd, sizes, strides = row[0], row[1:1 + sgd_update.MAX_DIMS], row[1 + sgd_update.MAX_DIMS:]
    out = []
    for i in range(p.numel()):  # csrc/sgd_update.cu g_offset
        off = 0
        for d in range(nd - 1, 0, -1):
            off += (i % sizes[d]) * strides[d]
            i //= sizes[d]
        out.append(flat[off + i * strides[0]])
    return torch.stack(out)


def _laid_out(x, layout):
    if layout == "channels_last":
        return x.contiguous(memory_format=CL)
    if layout == "hwio":  # the block engine's dW, (3, 3, C, F) in memory
        return x.permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)
    if layout == "transposed":
        return x.t().contiguous().t()
    return x.contiguous()


@pytest.mark.parametrize("shape,p_layout,g_layout", [
    ((12, 48, 3, 3), "contiguous", "hwio"),
    ((48, 3, 3, 3), "contiguous", "channels_last"),
    ((16, 5, 3, 3), "channels_last", "contiguous"),
    ((16, 5, 3, 3), "channels_last", "hwio"),
    ((1, 192, 1, 1), "contiguous", "channels_last"),
    ((7, 1, 3, 3), "contiguous", "hwio"),
    ((6, 9), "contiguous", "transposed"),
    ((4, 4, 4, 4), "hwio", "hwio"),
])
def test_layout_rows_read_each_gradient_element_at_its_parameters_offset(
        shape, p_layout, g_layout):
    """For a gradient laid out otherwise than its parameter, the kernel's
    index arithmetic on the wrapper's row reads, at the parameter's flat
    offset i, the gradient element of the parameter's i-th stored
    element."""
    x = torch.arange(float(np.prod(shape))).reshape(shape)
    p, g = _laid_out(torch.zeros(shape), p_layout), _laid_out(x, g_layout)
    want = p.clone().copy_(x).as_strided((p.numel(),), (1,))  # x in p's memory order
    assert torch.equal(_gather(p, g), want)


def test_layouts_the_kernel_cannot_read_are_copied():
    """An expanded (overlapping) gradient goes through a copy, and one
    that differs from its parameter only along dimensions of size 1 is read
    flat."""
    assert sgd_update._layout((4, 3), (3, 1), (0, 1)) is sgd_update._COPY
    assert sgd_update._layout((1, 192, 1, 1), (192, 1, 1, 1), (192, 1, 192, 192)) is None
    assert sgd_update._layout((2, 3, 4, 5, 6), (360, 120, 30, 6, 1),
                              (1, 2, 6, 24, 120)) is sgd_update._COPY
    assert sgd_update._dense((16, 5, 3, 3), (45, 1, 15, 5))
    assert not sgd_update._dense((4, 3), (0, 1))


def test_pair_check_is_kept_while_the_tensors_stay_put(monkeypatch):
    """The parameters' and momentum buffers' check is kept for the same
    tensors at the same data pointers, and made again for other tensors at
    those addresses or for a tensor whose storage moved (here it then
    refuses the CPU)."""
    params, momentum = [torch.zeros(2, 3)], [torch.zeros(2, 3)]
    tensors = params + momentum
    ptrs = [t.data_ptr() for t in tensors]
    monkeypatch.setattr(sgd_update, "_checked", (
        [weakref.ref(t) for t in tensors], ptrs, ["shapes"], ["strides"]))
    assert sgd_update._check_pair(params, momentum, ptrs) == (["shapes"], ["strides"])
    with pytest.raises(ValueError, match="one CUDA device"):
        sgd_update._check_pair([p.view(3, 2) for p in params], momentum, ptrs)
    params[0].data = params[0].data.clone()
    with pytest.raises(ValueError, match="one CUDA device"):
        sgd_update._check_pair(params, momentum, [t.data_ptr() for t in tensors])
